"""LM launchers: serving (``serve``), training (``train``) and the jet
smoothness regularizer (``ntp_reg``)."""
