"""Training objectives of the Adam-step cells, one module each: how the
port builds the objective (``program``), how its points are drawn
(``draw``), the jets one loss evaluation needs (``jets``), whether the
port computes the network's readout on its kernels (``READOUT_ON_KERNEL``),
and the plain reference's loss on the same weights and points
(``reference_loss``)."""
