"""The attention trunk (``pinn-pde-trunk``): each input coordinate is a
token x_t w_t + b_t; ``depth`` pre-norm blocks x + Attn(RMSNorm(x)) and
x + MLP(RMSNorm(x)); a final RMSNorm, the mean over tokens and a linear
head.  RMSNorm is x rsqrt(mean(x^2) + 1e-6) gamma; attention is
softmax(q k^T / sqrt(head_dim)) v over the tokens, heads concatenated,
then W_o; the MLP is tanh(x W_1 + b_1) W_2 + b_2.

Leaves in the order the harness hands them (dicts by sorted key): the
embedding's w (d_in, d) and b (d_in, d); per block gamma_1, W_k, W_o,
W_q, W_v, gamma_2, W_1, b_1, W_2, b_2; the final gamma; the head's w
(d, d_out) and b (d_out,)."""

from __future__ import annotations

import math

import torch

from . import taylor as T

EPS = 1e-6


class Trunk:
    def __init__(self, cfg: dict, leaves: list):
        self.cfg = cfg
        it = iter(leaves)
        self.emb_w, self.emb_b = next(it), next(it)
        self.blocks = []
        for _ in range(cfg["depth"]):
            g1, wk, wo, wq, wv, g2, w1, b1, w2, b2 = (next(it) for _ in range(10))
            self.blocks.append(dict(g1=g1, wk=wk, wo=wo, wq=wq, wv=wv, g2=g2,
                                    w1=w1, b1=b1, w2=w2, b2=b2))
        self.g_final, self.head_w, self.head_b = next(it), next(it), next(it)
        if next(it, None) is not None:
            raise ValueError("more leaves than the trunk holds")

    @staticmethod
    def _rms_norm(c, gamma):
        ms = T.mul(c, c).mean(dim=-1, keepdim=True)
        ms = torch.cat([ms[:1] + EPS, ms[1:]])
        return T.mul(c, T.power(ms, -0.5)) * gamma

    def _attention(self, c, p):
        h = self.cfg["net_kwargs"]["n_heads"]
        heads = lambda a: a.reshape(tuple(a.shape[:-1]) + (h, -1))   # (K+1, N, T, H, Dh)
        q, k, v = heads(c @ p["wq"]), heads(c @ p["wk"]), heads(c @ p["wv"])
        dh = q.shape[-1]
        n = c.shape[0]
        s = torch.stack([sum(torch.einsum("nqhd,nkhd->nhqk", q[i], k[m - i])
                             for i in range(m + 1)) for m in range(n)]) / math.sqrt(dh)
        shift = s[0].amax(dim=-1, keepdim=True).detach()
        e = T.exp(torch.cat([s[:1] - shift, s[1:]]))
        prob = T.div(e, e.sum(dim=-1, keepdim=True))
        o = torch.stack([sum(torch.einsum("nhqk,nkhd->nqhd", prob[i], v[m - i])
                             for i in range(m + 1)) for m in range(n)])
        return o.reshape(tuple(o.shape[:-2]) + (-1,)) @ p["wo"]

    def jet(self, c: torch.Tensor) -> torch.Tensor:
        """(K+1, N, d_in) -> (K+1, N, d_out)."""
        x = c[..., None] * self.emb_w
        x = torch.cat([x[:1] + self.emb_b, x[1:]])
        for p in self.blocks:
            x = x + self._attention(self._rms_norm(x, p["g1"]), p)
            y = T.tanh(T.linear(self._rms_norm(x, p["g2"]), p["w1"], p["b1"]))
            x = x + T.linear(y, p["w2"], p["b2"])
        x = self._rms_norm(x, self.g_final).mean(dim=-2)
        return T.linear(x, self.head_w, self.head_b)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.jet(x[None])[0]


def build(cfg: dict, leaves: list) -> Trunk:
    return Trunk(cfg, leaves)
