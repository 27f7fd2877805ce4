"""CUDA route for the Berrut/barycentric encode projection — the fixed
linear map from the k member queries to the r rational-interpolation parity
queries of the approxifer scheme,

    out[j] = sum_i C[j, i] * Q[i]          (Q [k, B, F], C [r, k])

Replaces ``repro/kernels/berrut_encoder.py:berrut_encode``, which is the
learned-encoder projection with the weight matrix transposed: with
``h = Q`` (reduce over k instead of H) and ``w = C^T`` the same kernel
(``csrc/parity_kernels.cu:project_kernel``) serves both call surfaces, so
there is one kernel to tune.  The launch is counted here, under
``berrut_encode``, and not under ``learned_project``."""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels import learned_encoder

launches = _build.LaunchCounter("berrut_encode")


def berrut_encode(q, c):
    """q [k, B, F] (fp32 or bf16, CUDA, contiguous); c [r, k] fp32 ->
    [r, B, F] in q's dtype (one launch for all r rows)."""
    out, ran = learned_encoder.launch(q, c.T.contiguous(), "berrut_encode")
    if ran:
        launches.add()
    return out
