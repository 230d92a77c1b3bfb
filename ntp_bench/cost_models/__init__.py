"""The jet layers one forward of a network needs, one module a network
kind: ``<network>.py`` holds ``jet_forward(cfg, rows, n1, readout_on_kernel)``,
built from the frozen counts of ``ntp_bench/cost.py``.  ``cost.jet_forward``
finds the module by the configuration's ``network``, so a configuration of
another network kind brings its cost model as a new file."""
