"""The paper's own deployed-model family for image tasks: the 2-hidden-layer
MLP, a LeNet-5-style CNN, and a small ResNet (CIFAR-scale); parity models
reuse the same architectures per §3.3 of the paper.

Plain functions on parameter trees, with the JAX package's layouts: dense
weights [in, out], convolution weights HWIO and activations NHWC at every
public function (``conv2d`` permutes to PyTorch's NCHW/OIHW inside).  A numpy
input is moved to the parameters' device.  Initialisers draw from a
``torch.Generator`` seeded with an int, so their numbers differ from the JAX
package's; carry JAX parameters across with ``convert.params_from_numpy``
where the two must agree.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.convert import as_tensor, resolve_device


def _gen(seed):
    return torch.Generator().manual_seed(int(seed))


def _dense(g, shape, dev):
    return (torch.randn(shape, generator=g) *
            math.sqrt(2.0 / shape[0])).to(dev)


def _conv(g, shape, dev):  # HWIO
    fan_in = shape[0] * shape[1] * shape[2]
    return (torch.randn(shape, generator=g) * math.sqrt(2.0 / fan_in)).to(dev)


def _same_pads(size, window, stride):
    """(low, high) padding of XLA's "SAME" rule along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride=1):
    """x [N, H, W, C] NHWC; w [KH, KW, C, O] HWIO; "SAME" padding."""
    ph = _same_pads(x.shape[1], w.shape[0], stride)
    pw = _same_pads(x.shape[2], w.shape[1], stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- MLP ----
def init_mlp(seed, in_dim, hidden=(200, 100), n_out=10, device="cuda"):
    dev = resolve_device(device)
    g = _gen(seed)
    dims = (in_dim,) + tuple(hidden) + (n_out,)
    return {"w": [_dense(g, (dims[i], dims[i + 1]), dev)
                  for i in range(len(dims) - 1)],
            "b": [torch.zeros((dims[i + 1],), device=dev)
                  for i in range(len(dims) - 1)]}


def mlp_fwd(p, x):
    x = as_tensor(x, p["w"][0].device)
    x = x.reshape(x.shape[0], -1)
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w + b
        if i < len(p["w"]) - 1:
            x = torch.relu(x)
    return x


# --------------------------------------------------------------- LeNet ----
def init_lenet(seed, image_shape=(32, 32, 3), channels=(6, 16), n_out=10,
               device="cuda"):
    dev = resolve_device(device)
    g = _gen(seed)
    c_in = image_shape[-1]
    flat = (image_shape[0] // 4) * (image_shape[1] // 4) * channels[1]
    return {
        "c1": _conv(g, (5, 5, c_in, channels[0]), dev),
        "c2": _conv(g, (5, 5, channels[0], channels[1]), dev),
        "fc": init_mlp(int(torch.randint(0, 2**31 - 1, (1,), generator=g)),
                       flat, (120, 84), n_out, device=dev),
    }


def _pool(x):
    """2x2 max pool, stride 2, "SAME" padding with -inf (NHWC)."""
    ph = _same_pads(x.shape[1], 2, 2)
    pw = _same_pads(x.shape[2], 2, 2)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]),
               value=-math.inf)
    return F.max_pool2d(xc, 2, 2).permute(0, 2, 3, 1)


def lenet_fwd(p, x):
    x = as_tensor(x, p["c1"].device)
    x = _pool(torch.relu(conv2d(x, p["c1"])))
    x = _pool(torch.relu(conv2d(x, p["c2"])))
    return mlp_fwd(p["fc"], x)


# -------------------------------------------------------------- ResNet ----
def init_resnet(seed, image_shape=(32, 32, 3), stages=(16, 32, 64), n_out=10,
                blocks_per_stage=2, device="cuda"):
    dev = resolve_device(device)
    g = _gen(seed)
    p = {"stem": _conv(g, (3, 3, image_shape[-1], stages[0]), dev),
         "stages": []}
    c_in = stages[0]
    for c in stages:
        blocks = []
        for b in range(blocks_per_stage):
            blk = {"c1": _conv(g, (3, 3, c_in if b == 0 else c, c), dev),
                   "c2": _conv(g, (3, 3, c, c), dev)}
            if b == 0 and c_in != c:
                blk["proj"] = _conv(g, (1, 1, c_in, c), dev)
            blocks.append(blk)
        p["stages"].append(blocks)
        c_in = c
    p["head"] = _dense(g, (c_in, n_out), dev)
    p["head_b"] = torch.zeros((n_out,), device=dev)
    return p


def resnet_fwd(p, x):
    x = as_tensor(x, p["stem"].device)
    x = torch.relu(conv2d(x, p["stem"]))
    for si, blocks in enumerate(p["stages"]):
        for bi, blk in enumerate(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            h = torch.relu(conv2d(x, blk["c1"], stride))
            h = conv2d(h, blk["c2"])
            sc = x if "proj" not in blk else conv2d(x, blk["proj"], stride)
            if stride == 2 and "proj" not in blk:
                sc = sc[:, ::2, ::2, :]
            x = torch.relu(h + sc)
    x = x.mean(dim=(1, 2))
    return x @ p["head"] + p["head_b"]


MODEL_FNS = {"mlp": (init_mlp, mlp_fwd),
             "lenet": (init_lenet, lenet_fwd),
             "resnet": (init_resnet, resnet_fwd)}


def build(kind, seed, image_shape=(32, 32, 3), n_out=10, device="cuda"):
    """(params, fwd) for ``kind``; ``seed`` (an int) seeds the init."""
    if kind == "mlp":
        in_dim = math.prod(image_shape)
        return init_mlp(seed, in_dim, n_out=n_out, device=device), mlp_fwd
    if kind == "lenet":
        return init_lenet(seed, image_shape, n_out=n_out,
                          device=device), lenet_fwd
    if kind == "resnet":
        return init_resnet(seed, image_shape, n_out=n_out,
                           device=device), resnet_fwd
    raise ValueError(kind)
