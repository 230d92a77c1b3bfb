"""LM launchers: serving (``serve``), training (``train``), the jet
smoothness regularizer (``ntp_reg``), device meshes (``mesh``) and the
sharded step builders (``sharding``)."""
