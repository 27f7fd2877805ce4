"""Linear deployed model — for property tests of the coding layer.

For any *linear* F, the paper's addition/subtraction code is exact with the
identity parity model F_P = F (Table 1, row 1).
"""
import math

import torch

from repro_torch.convert import as_tensor, resolve_device


def init_linear(seed, d_in, d_out, device="cuda"):
    g = torch.Generator().manual_seed(int(seed))
    w = torch.randn((d_in, d_out), generator=g) / math.sqrt(d_in)
    return {"w": w.to(resolve_device(device))}


def linear_fwd(p, x):
    x = as_tensor(x, p["w"].device)
    return x.reshape(x.shape[0], -1) @ p["w"]
