"""The port's joint learned-encoder + parity train step
(``training/train_lib.make_joint_parity_train_step``) against the JAX
package, on the CPU, three steps with the ``learned`` scheme at r = 1 and 2
on reduced smollm-135m and reduced qwen2-0.5b (QKV bias).

The same seeded numpy parameters, encoder draw, member embeddings and
teacher logits go through both packages; parameters are carried across with
``params_from_numpy``.  The comparison harness and its tolerances are
``test_torch_parity_train.py``'s: losses 1e-5 relative, parameters 1e-6
after three steps, with Adam's eps at 1e-3 (``tests/test_torch_train.py``
says why).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import scheme as jscheme
from repro.training import train_lib as jtrain
from repro_torch.convert import tree_map
from repro_torch.core import scheme as tscheme
from repro_torch.training import train_lib as ttrain
from test_torch_parity_train import (ARCHS, K, _batches, _cfgs, _params,
                                     _run_both)


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_joint_parity_train_step_equals_reference(arch, r):
    """The learned encoder and r parity LMs trained jointly from the same
    encoder draw; the encoder's alpha leaves 0 (the plain sum code), and
    the scheme's own encoder params stay as they were."""
    jcfg, tcfg = _cfgs(arch)
    jsch = jscheme.get_scheme("learned", k=K, r=r)
    tsch = tscheme.get_scheme(
        "learned", k=K, r=r, device="cpu",
        enc_params=jax.tree.map(np.asarray, jsch.enc_params))
    np.testing.assert_allclose(tsch.host_coeffs, np.asarray(jsch.coeffs))
    draws = [_params(jcfg, 10 + j) for j in range(r)]
    jp = {"enc": jsch.enc_params, "parity": [d[0] for d in draws]}
    tp = {"enc": tree_map(torch.clone, tsch.enc_params),
          "parity": [d[1] for d in draws]}
    _run_both(lambda o: jtrain.make_joint_parity_train_step(jcfg, o, jsch),
              lambda o: ttrain.make_joint_parity_train_step(tcfg, o, tsch),
              jp, tp, _batches(jcfg))
    assert float(tp["enc"]["alpha"].detach()) != 0.0
    assert float(tsch.enc_params["alpha"]) == 0.0
