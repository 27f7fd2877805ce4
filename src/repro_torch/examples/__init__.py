"""Twins of the JAX package's ``examples/`` drivers on the port.

Each module keeps its reference's arguments, defaults, sizes and printed
lines, adds ``--device`` (``cuda`` by default, raising without a card;
``cpu`` runs the kernels' plain versions), and returns what it prints from
``main(argv=None)`` as a dict:

* ``quickstart``      — train the deployed MLP and its ``sum`` parity model
  (k=2), encode one group, rebuild the missing prediction (B1, B3);
* ``serve_parm``      — the threads engine with a straggling instance, then
  the same ``DeploymentSpec`` through the DES;
* ``latency_study``   — one ``DeploymentSpec`` per strategy through the DES;
* ``serve_lm``        — reduced qwen2-0.5b behind ``deploy_lm`` with a
  straggling member, then the token-level DES (B7, B8);
* ``train_parity_lm`` — a reduced LM, its parity LM on summed embeddings,
  and the degraded-mode top-1 agreement (B7 in the teacher forwards).

Run one as ``PYTHONPATH=src python -m repro_torch.examples.<name>``.
"""
