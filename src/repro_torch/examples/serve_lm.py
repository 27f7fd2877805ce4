"""Coded autoregressive LM serving on the port, end to end (twin of
``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--requests 4] \
        [--k 2] [--slots 2] [--max-new 4] [--straggle-ms 120] [--device cpu]

Deploys a tiny transformer (reduced qwen2-0.5b, random weights from seed 0)
behind ``deploy_lm(spec, engine="threads")``: k member instances serve
multi-token requests out of per-slot KV-cache pools (continuous batching —
requests join and leave at token boundaries), while a parity instance
decodes the embedding-encoded sum of the member streams.  Member 0 is
artificially straggled: every decode step it misses, the scheduler
reconstructs its logits from the parity stream and the stream keeps
emitting tokens without waiting.  On the card every prefill runs B7 and
every decode step B8, on their fp32 routes (the reduced config is fp32).

The SAME deployment shape then replays through the token-level DES at a
qwen3-moe-235b roofline-calibrated service time — the big-config tail study
(coded vs uncoded equal-resources).  The port prices a token on the H100
data sheet's rates (``launch.roofline.H100_SXM``), where the reference
prices it on its own accelerator's, so the two service times differ;
:func:`sim_study` takes the rates as an argument.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config
from repro_torch.convert import resolve_device
from repro_torch.launch.roofline import H100_SXM
from repro_torch.models import transformer as T
from repro_torch.serving.api import BatchingPolicy, deploy_lm
from repro_torch.serving.generation import GenerationSpec, token_service_ms
from repro_torch.serving.scenarios import instance_id


def sim_study(n_tokens, device="cuda", hardware=H100_SXM):
    """The token-level DES of qwen3-moe-235b-a22b at k=4, r=1, m=12, 30%
    utilization, kv_len 4096, tp 8, under the ``bursty`` scenario, coded
    and uncoded (``equal_resources``), seed 1: (service ms, coded report,
    uncoded report)."""
    lm = GenerationSpec(cfg=get_config("qwen3-moe-235b-a22b"), k=4, r=1,
                        m=12, utilization=0.3, kv_len=4096, tp=8,
                        scenario="bursty", device=device, hardware=hardware)
    coded = deploy_lm(lm, engine="sim").replay(n_tokens=n_tokens, seed=1)
    uncoded = deploy_lm(lm.replace(strategy="equal_resources"),
                        engine="sim").replay(n_tokens=n_tokens, seed=1)
    return token_service_ms(lm), coded, uncoded


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--straggle-ms", type=float, default=120.0)
    ap.add_argument("--sim-tokens", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # threads engine: real model, one deliberately slow member ------------
    cfg = get_config("qwen2-0.5b", reduced=True)
    params = T.init_params(cfg, 0, device=dev)
    slow = instance_id("main", 0)
    spec = GenerationSpec(
        cfg=cfg, params=params, k=args.k, r=1, scheme="sum",
        batching=BatchingPolicy(max_size=args.slots), max_seq_len=32,
        max_new_tokens=args.max_new, straggle_ms=args.straggle_ms,
        delay_fn=lambda iid: 0.4 if iid == slow else 0.0, device=str(dev))
    prompts = [[(7 * i + j) % cfg.vocab for j in range(3 + i % 3)]
               for i in range(args.requests)]
    out = {"requests": []}
    with deploy_lm(spec, engine="threads") as sess:
        futs = [sess.submit(p) for p in prompts]
        if not sess.wait_all(300.0):
            raise SystemExit("generation did not drain")
        for f in futs:
            out["requests"].append({"rid": f.rid, "tokens": f.result(),
                                    "reconstructed_steps":
                                        f.reconstructed_steps})
            print(f"request {f.rid}: tokens={f.result()} "
                  f"reconstructed_steps={f.reconstructed_steps}")
        report = sess.stats()
    out.update(done=sum(f.done() for f in futs), summary=report.summary(),
               tokens_per_s=report.tokens_per_s,
               inter_token_p50_ms=report.inter_token_p50_ms,
               inter_token_p999_ms=report.inter_token_p999_ms,
               reconstructed_steps=report.reconstructed_steps)
    print(report.summary())
    print(f"threads: tokens/s={report.tokens_per_s:.1f} "
          f"inter-token p50={report.inter_token_p50_ms:.1f}ms "
          f"p999={report.inter_token_p999_ms:.1f}ms "
          f"reconstructed={report.reconstructed_steps}")
    if report.reconstructed_steps <= 0:
        raise AssertionError("straggled member never coded over")

    # sim engine: big-config tail study at roofline service time ----------
    step_ms, coded, uncoded = sim_study(args.sim_tokens, str(dev))
    out.update(sim_step_ms=step_ms, sim_coded=coded.summary(),
               sim_uncoded=uncoded.summary())
    print(f"\nsim: qwen3-moe-235b decode step = {step_ms:.2f}ms"
          f" (roofline, kv_len=4096, tp=8, {H100_SXM.name})")
    print(f"sim coded:   {coded.summary()}")
    print(f"sim uncoded: {uncoded.summary()}")
    print(f"inter-token p999: coded {coded.inter_token_p999_ms:.1f}ms vs "
          f"uncoded {uncoded.inter_token_p999_ms:.1f}ms "
          f"({coded.inter_token_p999_ms / uncoded.inter_token_p999_ms:.2f}x"
          f" at {coded.inter_token_p50_ms / uncoded.inter_token_p50_ms:.2f}x"
          f" the median)")
    return out


if __name__ == "__main__":
    main()
