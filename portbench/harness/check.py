"""The comparison that decides ``correct``: what the timed path produced,
held to the plain reference (``reference.py``) after the window.

What is compared:

* served tokens: a sample of requests drawn from the seed (the streams of
  the checked slot columns, the longest finished request, and finished
  ones drawn from the seed), each run through the reference over its
  prompt and served tokens; a token's gap is how far the reference's
  logit of the served token lies below the reference's best (members'
  prefill, decode through the cache, B7, B8, the MoE experts);
* the coding path: for slot columns drawn from the seed that both members
  occupy, every captured decode round since the column's occupants last
  changed: the parity instance's logits against the reference's logits of
  the encoded input (the sum of the members' token embeddings,
  right-aligned over their histories, as the parity's cache was rebuilt
  and then extended), and each member's logits rebuilt from the parity's
  and the other member's by the session's own decode against the
  reference's rebuild (reference parity less reference member).  No
  member straggles in the window, so the rebuild runs here, on the
  window's own outputs.  The parity's position each round must be the
  longer member's (``parity_position_mismatches``);
* emission: in every round captured, each token a member's stream in a
  captured slot column emitted has to be the first-ranked of that
  member's own decode row (``served_not_argmax``, exact): a token altered
  between the model's logits and the stream is one wrong token among
  many, which a percentile of gaps does not see.

Each path is read as gaps of the first-ranked token and as relative RMS
errors of whole logit rows, widest and at a percentile over tokens or rows
(``_readings``); the cell's ``limits`` (in its traffic file) name the
numbers compared, chosen where the program's readings and the control's
separate (``PERF.md``).  With ``control`` the fp8 reference stands in the
program's place at the same positions and the same numbers are read of
it; with ``control="router_bf16"`` the witness of routing flips: the
fp32 reference with only its router's input rounded through bf16."""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import traffic as T, window as W
from portbench.harness.reference import Reference


def _gap(ref_row, pick):
    return float(ref_row.max() - ref_row[pick])


def _rel_err(prog, ref):
    return float(torch.sqrt(((prog - ref) ** 2).mean() / (ref ** 2).mean()))


def _ranked(logits):
    return int(torch.argmax(logits))


def columns(traffic, seed):
    """The slot columns whose decode rows the capture keeps: drawn from the
    seed, two more than the comparison takes (some may be half empty at
    the end)."""
    n = traffic["slots_per_member"]
    want = min(n, traffic["check"]["parity_columns"] + 2)
    return sorted(T.rng(seed, 4).choice(n, want, replace=False).tolist())


def sample(load, traffic, seed):
    """(the newest captured round with as many full checked columns as
    any (a column both members occupy), its step record, the columns to check
    with the captured rounds of each that share that round's occupancy,
    the sampled requests).  The requests are the checked columns'
    streams, the longest finished request, and finished ones drawn from
    the seed."""
    cap = load.capture
    steps = {st[0]: st for st in cap.steps}
    names = {f"lm-member-{i}" for i in range(load.session_k)} | {
        "lm-parity-0"}
    kept = [(rnd, rows) for rnd, rows in cap.rows if set(rows) >= names]

    def full_cols(rnd):
        rids = steps[rnd][1]
        return [j for j, s in enumerate(cap.cols) if (rids[:, s] >= 0).all()]
    want = traffic["check"]["parity_columns"]
    at = max(range(len(kept)), key=lambda n: (
        min(len(full_cols(kept[n][0])), want), n))
    kept = kept[:at + 1]
    newest = steps[kept[-1][0]]
    rids = newest[1]
    k = rids.shape[0]
    gen = T.rng(seed, 3)
    full = full_cols(newest[0])
    n_cols = min(traffic["check"]["parity_columns"], len(full))
    picked = sorted(gen.choice(full, n_cols, replace=False).tolist()) \
        if n_cols else []
    checks = []
    for j in picked:
        s = cap.cols[j]
        rounds = []
        for rnd, rows in reversed(kept):
            if not (steps[rnd][1][:, s] == rids[:, s]).all():
                break
            rounds.append((steps[rnd], {n: r[j] for n, r in rows.items()}))
        checks.append((s, rounds[::-1]))
    by_rid = {r.future.rid: r for r in load.requests}
    chosen = [by_rid[int(rids[i, s])] for s, _ in checks for i in range(k)]
    served = [r for r in load.requests if r.future.done() and r.tokens
              and r not in chosen]
    if served:
        longest = max(served, key=lambda r: len(r.prompt) + len(r.tokens))
        chosen.append(longest)
        served.remove(longest)
    extra = traffic["check"]["requests"] - len(chosen)
    if extra > 0 and served:
        pick = gen.choice(len(served), min(extra, len(served)), replace=False)
        chosen += [served[i] for i in sorted(pick.tolist())]
    return newest, checks, chosen


def _capture_len(cap, s, upto):
    """The parity's prefill length for column s: its position at the first
    round of the column's current occupancy (the last rebuild)."""
    steps = [st for st in cap.steps if st[0] <= upto[0]]
    L_r = upto[3][0, s]
    for rnd, rids, pos, ppos in reversed(steps):
        if not (rids[:, s] == upto[1][:, s]).all():
            break
        L_r = ppos[0, s]
    return int(L_r)


def _stats(name, gaps, errs):
    out = {}
    if gaps is not None:
        out[f"{name}_gap"] = max(gaps, default=0.0)
        out[f"{name}_gap_p90"] = W.percentile(gaps, 90) or 0.0
    if errs is not None:
        out[f"{name}_rel_err"] = max(errs, default=0.0)
        out[f"{name}_rel_err_p50"] = W.percentile(errs, 50) or 0.0
    return out


def _readings(served, members, parity, rebuilt):
    """The numbers read of one side: served-token gaps; the members', the
    parity's and the rebuilt logits against the reference's (relative RMS
    error, and the gap of their first-ranked token), widest and a
    percentile over the rows."""
    out = _stats("served", served, None)
    out.update(_stats("member", None, [_rel_err(a, b) for a, b in members]))
    for name, rows in (("parity", parity), ("rebuilt", rebuilt)):
        out.update(_stats(name, [_gap(b, _ranked(a)) for a, b in rows],
                          [_rel_err(a, b) for a, b in rows]))
    return out


def not_argmax(load):
    """(tokens emitted that are not the first-ranked of their member's own
    captured decode row, tokens so checked); streams with a rebuilt step
    are passed over."""
    cap = load.capture
    steps = {st[0]: st for st in cap.steps}
    by_rid = {r.future.rid: r for r in load.requests}
    bad = seen = 0
    for rnd, picks in cap.picks:
        _, rids, pos, _ = steps[rnd]
        for name, row in picks.items():
            i = int(name.rsplit("-", 1)[1])
            for j, s in enumerate(cap.cols):
                r = by_rid.get(int(rids[i, s]))
                if r is None or r.future.reconstructed_steps:
                    continue
                at = int(pos[i, s]) - len(r.prompt) + 1
                toks = r.tokens
                if 0 <= at < len(toks):
                    seen += 1
                    bad += int(toks[at] != int(row[j]))
    return bad, seen


def compare(load, scheme, cfg, params, traffic, seed, n_slots,
            control=None):
    """{name: (value, limit)} of the compared numbers (those the cell's
    ``limits`` name, and the structural counts, limit 0) and the other
    readings as plain values; with ``control`` (``"fp8"``, or ``True``
    for it, or ``"router_bf16"``) that reference's readings."""
    newest, checks, chosen = sample(load, traffic, seed)
    k = newest[1].shape[0]
    ref = Reference(cfg, params, decode_batch=n_slots)
    quant = "fp8" if control is True else control
    ctl = Reference(cfg, params, quant=quant, decode_batch=n_slots) \
        if quant else None
    prog = {"served": [], "members": [], "parity": [], "rebuilt": []}
    side = {"served": [], "members": [], "parity": [], "rebuilt": []}
    rows = {}                        # rid -> (P, ref logits, ctl logits)
    for r in chosen:
        toks = r.tokens
        if not toks:
            continue
        P = len(r.prompt)
        positions = list(range(P - 1, P - 1 + len(toks)))
        x = ref.embed(r.prompt + toks[:-1])
        lg = ref.logits(x, P, positions)
        cl = ctl.logits(x, P, positions) if ctl else None
        for j, t in enumerate(toks):
            prog["served"].append(_gap(lg[j], t))
            if ctl:
                side["served"].append(_gap(lg[j], _ranked(cl[j])))
        rows[r.future.rid] = (P, lg, cl)
    mismatch = 0
    by_rid = {r.future.rid: r for r in load.requests}
    dev = params["embed"].device
    for s, rounds in checks:
        (_, rids, pos, ppos), _ = rounds[-1]
        inputs = []
        for i in range(k):
            r = by_rid[int(rids[i, s])]
            P = len(r.prompt)
            inputs.append(r.prompt + r.tokens[:int(pos[i, s]) - P + 1])
        L = max(len(h) for h in inputs)
        enc = torch.zeros((L, cfg["d_model"]), device=dev)
        for h in inputs:                 # the sum code: coefficients 1
            enc[L - len(h):] += ref.embed(h)
        at = [int(st[3][0, s]) for st, _ in rounds]
        p_all = ref.logits(enc, _capture_len(load.capture, s, rounds[-1][0]),
                           at)
        c_all = ctl.logits(enc, _capture_len(load.capture, s,
                                             rounds[-1][0]), at) \
            if ctl else None
        for n, ((_, _, pos_r, ppos_r), got) in enumerate(rounds):
            if int(ppos_r[0, s]) != int(max(pos_r[:, s])):
                mismatch += 1
            p_ref = p_all[n]
            m_ref, m_ctl = [], []
            for i in range(k):
                P, lg, cl = rows[int(rids[i, s])]
                m_ref.append(lg[int(pos_r[i, s]) - (P - 1)])
                m_ctl.append(cl[int(pos_r[i, s]) - (P - 1)] if ctl else None)
            mine = [got[f"lm-member-{i}"] for i in range(k)]
            pout = got["lm-parity-0"]
            prog["parity"].append((torch.as_tensor(pout, device=dev), p_ref))
            outs = np.stack(mine)[:, None, None]           # [k, 1, 1, V]
            for i in range(k):
                prog["members"].append((torch.as_tensor(mine[i], device=dev),
                                        m_ref[i]))
                mask = np.zeros(k, bool)
                mask[i] = True
                rec = scheme.decode(pout[None, None, None], outs, mask,
                                    np.ones(1, bool))[i, 0, 0]
                rest = [o for o in range(k) if o != i]
                prog["rebuilt"].append((
                    torch.as_tensor(rec, device=dev),
                    p_ref - sum(m_ref[o] for o in rest)))
                if ctl:
                    side["members"].append((m_ctl[i], m_ref[i]))
                    side["rebuilt"].append((
                        c_all[n] - sum(m_ctl[o] for o in rest),
                        p_ref - sum(m_ref[o] for o in rest)))
            if ctl:
                side["parity"].append((c_all[n], p_ref))
    lim = traffic["limits"]
    read = _readings(**prog)
    out = {name: (read[name], lim[name]) if name in lim else read[name]
           for name in read}
    bad, seen = not_argmax(load)
    out.update({"parity_position_mismatches": (mismatch, 0),
                "parity_unchecked": (int(not checks), 0),
                "served_not_argmax": (bad, 0),
                "argmax_checked_tokens": seen,
                "checked_tokens": len(prog["served"]),
                "checked_columns": len(checks),
                "checked_rounds": len(prog["parity"])})
    out.update(ref.moe_counts())
    if not ctl:
        return out, None
    side = _readings(**side)
    side.update(ctl.moe_counts())
    return out, side
