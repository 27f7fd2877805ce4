"""Drives the system under test, ``repro_torch.serving.generation``'s
threads engine (``deploy_lm(spec, engine="threads")``), with a cell's
traffic, and keeps what the comparison needs.

What is read of the program besides its public surface (``submit``,
``GenerationFuture``, ``wait_all``, ``shutdown``): the futures' timestamps
(``_times``: the admission, then one per token), the session's slots at
each decode round (``_slots``, ``_ppos``), the outputs of its decode jobs
(each instance's executor ``submit``), its coding scheme (``scheme``), and,
after the window, each active stream's ``max_new`` set to end it at its
next token."""
from __future__ import annotations

import collections
import threading
import time

import numpy as np


class Capture:
    """Per decode round: the (request id, position) of every (member, slot)
    and the parity positions; for the slot columns ``cols``, the rows of
    every instance's decode output over the last ``keep`` rounds, and the
    first-ranked token of each member's row in every round, until frozen.
    A round's rows are sliced out of its jobs' outputs once they are all
    in, so only those rows are kept."""

    def __init__(self, session, cols, keep=24):
        self.session, self.cols = session, list(cols)
        self.steps = []                   # (round, rids, pos, ppos)
        self.rows = collections.deque(maxlen=keep)   # (round, {name: rows})
        self.picks = []                   # (round, {member: argmax per col})
        self._pending = []                # (round, {name: job})
        self.frozen = False
        self._lock = threading.Lock()
        for inst in session._members + session._parities:
            self._wrap(inst)

    def _wrap(self, inst):
        orig = inst.ex.submit

        def submit(fn, label, delay=None):
            job = orig(fn, label, delay)
            if label[1] == "decode":
                with self._lock:
                    if not self.frozen:
                        self._keep(inst.name, label[2], job)
            return job
        inst.ex.submit = submit

    def _keep(self, name, rnd, job):
        s = self.session
        if not self.steps or self.steps[-1][0] != rnd:
            rids = np.full((s.k, s.n_slots), -1, np.int64)
            pos = np.zeros((s.k, s.n_slots), np.int64)
            for i in range(s.k):
                for j, st in enumerate(s._slots[i]):
                    if st is not None:
                        rids[i, j], pos[i, j] = st.rid, st.pos
            self.steps.append((rnd, rids, pos, s._ppos.copy()))
            self._pending.append((rnd, {}))
            self.collect(wait=False)
        self._pending[-1][1][name] = job

    def collect(self, wait=True):
        """Slice the rows of the pending rounds whose outputs are in (all of
        them, waiting, with ``wait``)."""
        while self._pending:
            rnd, jobs = self._pending[0]
            if len(self._pending) == 1 and not wait:
                return                    # the round still being submitted
            if not wait and not all(evt.is_set() for evt, _ in
                                    jobs.values()):
                return
            for evt, _ in jobs.values():
                evt.wait()
            rows = {name: np.array(out["result"][self.cols, 0])
                    for name, (_, out) in jobs.items() if "result" in out}
            self.rows.append((rnd, rows))
            self.picks.append((rnd, {
                name: r.argmax(-1) for name, r in rows.items()
                if name.startswith("lm-member-")}))
            self._pending.pop(0)


class Load:
    """One cell's session and traffic.  ``requests`` holds every request
    submitted, in order."""

    POLL_S = 0.005                 # a closed loop's clients
    WAIT_S = 0.05                  # a closed batch sends nothing

    def __init__(self, session, generator, traffic, cols):
        self.session, self.gen, self.traffic = session, generator, traffic
        self.capture = Capture(session, cols)
        self.requests = []
        self._queue = collections.deque()
        self._clients = []
        self.submitting = True

    def _next(self):
        if not self._queue:
            self._queue.extend(self.gen.block())
        return self._queue.popleft()

    def _submit(self):
        req = self._next()
        req.t_submit = time.monotonic()
        req.future = self.session.submit(req.prompt, req.max_new)
        self.requests.append(req)
        return req

    def start(self):
        t = self.traffic
        if t["kind"] == "closed_batch":
            for _ in range(t["streams"]):
                self._submit()
        else:
            self._clients = [self._submit() for _ in range(t["clients"])]

    def pump(self):
        """One poll: each closed-loop client whose reply ended sends its
        next request."""
        if not self.submitting:
            return
        for c, req in enumerate(self._clients):
            if req.future.done():
                self._clients[c] = self._submit()

    def until(self, cond, timeout):
        """Pump until ``cond()``; raises ``TimeoutError`` after
        ``timeout`` seconds."""
        end = time.monotonic() + timeout
        while not cond():
            self.session_alive()
            if time.monotonic() > end:
                raise TimeoutError("the session made no progress in "
                                   f"{timeout:.0f} s")
            self.pump()
            time.sleep(self.POLL_S if self._clients and self.submitting
                       else self.WAIT_S)

    def session_alive(self):
        err = self.session._error
        if err is not None:
            raise RuntimeError(f"the session failed: {err}") from err

    def done(self):
        return sum(1 for r in self.requests if r.future.done())

    def decoded(self):
        """Tokens emitted after streams' first tokens, so far."""
        return sum(max(0, len(r.future._times) - 2) for r in self.requests)

    def warm(self, timeout):
        """The traffic's warm-up, counted as set-up: a closed loop until
        ``warm_completions`` replies ended; a closed batch until every
        stream is admitted and ``warm_rounds`` rounds decoded."""
        t = self.traffic
        if t["kind"] == "closed_batch":
            n = t["streams"]
            self.until(lambda: self.decoded() >= n * t["warm_rounds"],
                       timeout)
        else:
            self.until(lambda: self.done() >= t["warm_completions"], timeout)

    def finish(self, w1, timeout=60.0):
        """Stop sending; wait until every request sent before ``w1`` has
        its first token and nothing waits for admission; freeze the
        capture; end every active stream at its next token; wait for all
        and shut the session down."""
        self.submitting = False
        s = self.session

        def settled():
            with s._lock:
                waiting = bool(s._waiting)
            return not waiting and all(
                len(r.future._times) >= 2 for r in self.requests
                if r.t_submit < w1)
        self.until(settled, timeout)
        with self.capture._lock:
            self.capture.frozen = True
            self.capture.collect()
        with s._lock:
            for row in s._slots:
                for st in row:
                    if st is not None:
                        st.max_new = 0
        if not s.wait_all(timeout=timeout):
            raise TimeoutError("streams did not end after the window")
        s.shutdown()
