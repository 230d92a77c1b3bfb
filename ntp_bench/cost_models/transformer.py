"""The attention trunk over coordinate tokens: per block K3, the q/k/v
projections (K1), K4 with the output projection, K3 and the MLP's two K1
layers; then a final K3 and the head.  The embedding, the residual adds
and the token mean are linear and left out."""

from __future__ import annotations

from ntp_bench import cost


def jet_forward(cfg: dict, rows: int, n1: int, readout_on_kernel: bool = True) -> list:
    dt, d, t = cfg["dtype"], cfg["width"], cfg["d_in"]
    h, ratio = cfg["net_kwargs"]["n_heads"], cfg["net_kwargs"]["mlp_ratio"]
    tokens = rows * t
    block = [cost.rms_norm(tokens, d, n1, dt),
             *(cost.dense(tokens, d, d, n1, False, dt) for _ in range(3)),
             cost.flash_attention(rows, h, t, d // h, d, n1, dt),
             cost.rms_norm(tokens, d, n1, dt),
             cost.dense(tokens, d, ratio * d, n1, True, dt),
             cost.dense(tokens, ratio * d, d, n1, False, dt)]
    return block * cfg["depth"] + [cost.rms_norm(tokens, d, n1, dt),
                                   cost.dense(rows, d, cfg["d_out"], n1, False, dt)]
