"""Traffic drivers, one a kind of work: ``adam_steps`` (training),
``offline_tables`` (back-to-back ``grid`` calls) and ``open_loop``
(requests into the server at fixed due times).  A cell's file names its
driver and holds every parameter the driver reads; a new mix of an
existing kind is a new file of data."""
