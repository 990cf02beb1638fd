"""The port's fleet router against the JAX package's router suite
(``tests/fleet/test_router.py``), test for test, on the CPU.

Pure host-side — replicas are stubs exposing exactly the surface the
router ranks on (queue, slots occupancy, ``submit_request``), so every
policy decision is checked without building an engine.  Also home to the
direct :class:`RequestQueue` ``peek``/``requeue`` tests and the
``poisson_trace`` prefix-stability regression.  One cross-check drives the
port's and the JAX package's routers through the same seeded sequence of
dispatches, drains, failures and vetoes on the same stubs: placements,
deferrals, sheds and their reasons must be equal.
"""
import numpy as np
import pytest

from repro.serving import batching as jbatching
from repro.serving import fleet as jfleet
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving import batching as tbatching
from repro_torch.serving import fleet as tfleet
from repro_torch.serving.batching import (QueueFullError, Request,
                                          RequestQueue, RequestState,
                                          poisson_trace)
from repro_torch.serving.fleet import (POLICIES, ReplicaHandle, ReplicaState,
                                       Router)


class _StubSlots:
    def __init__(self, n_slots, n_free):
        self.n_slots, self.n_free = n_slots, n_free


class _StubEngine:
    def __init__(self, n_slots=2, occupied=0, max_queue=4,
                 queue_cls=RequestQueue):
        self.queue = queue_cls(max_queue)
        self.slots = _StubSlots(n_slots, n_slots - occupied)

    def submit_request(self, req):
        return self.queue.submit(req)


def _fleet(loads, **kw):
    """Handles with the given (queue_depth, occupied) pairs."""
    out = []
    for i, (depth, occ) in enumerate(loads):
        h = ReplicaHandle(i, _StubEngine(occupied=occ, **kw))
        for _ in range(depth):
            h.engine.queue.submit(_req())
        out.append(h)
    return out


def _req(**kw):
    return Request(prompt=np.ones(4, np.int32), max_new_tokens=2, **kw)


# ------------------------------------------------------------------ policies

def test_policy_names_are_the_public_contract():
    assert POLICIES == ("round-robin", "least-loaded")
    with pytest.raises(ValueError, match="unknown router policy"):
        Router(_fleet([(0, 0)]), policy="weighted")
    with pytest.raises(ValueError, match="at least one replica"):
        Router([], policy="round-robin")


def test_round_robin_rotates_across_up_replicas():
    r = Router(_fleet([(0, 0), (0, 0), (0, 0)]), policy="round-robin")
    picks = [r.dispatch(_req()).idx for _ in range(5)]
    assert picks == [0, 1, 2, 0, 1]


def test_round_robin_skips_full_replica():
    replicas = _fleet([(0, 0), (0, 0)], max_queue=1)
    r = Router(replicas, policy="round-robin")
    assert r.dispatch(_req()).idx == 0
    assert r.dispatch(_req()).idx == 1
    # both at bound now: drain replica 1 only; the rotation wants 0 next
    # but 0 is full, so the dispatch lands on 1 (skip, not shed)
    replicas[1].engine.queue.pop()
    assert r.dispatch(_req()).idx == 1


def test_least_loaded_ranks_by_queue_plus_slots():
    # loads: r0 = 2+0 = 2, r1 = 0+1 = 1, r2 = 1+2 = 3  -> r1 wins
    r = Router(_fleet([(2, 0), (0, 1), (1, 2)]), policy="least-loaded")
    assert r.dispatch(_req()).idx == 1


def test_least_loaded_tie_breaks_on_lowest_index_deterministically():
    for _ in range(3):   # no hidden state: same tie, same answer, every time
        r = Router(_fleet([(1, 1), (2, 0), (1, 1)]), policy="least-loaded")
        picks = [r.dispatch(_req()).idx for _ in range(2)]
        # all tied at load 2; r0 wins, then holds load 3 so r1/r2 tie at 2
        assert picks == [0, 1]


def test_dispatch_defers_when_every_candidate_is_full():
    r = Router(_fleet([(1, 0)], max_queue=1), policy="round-robin")
    req = _req()
    assert r.dispatch(req) is None
    assert not req.done                  # backpressure: intake retries later
    assert r.shed == [] and r.n_dispatched == 0


def test_deadline_shed_is_exact():
    r = Router(_fleet([(0, 0)]), policy="round-robin")
    before = obs_metrics.counter("fleet.shed").value(reason="deadline")
    req = _req(deadline_s=0.5)
    req.t_arrival = 100.0                # queued at t=100, deadline t=100.5
    assert r.dispatch(req, now=100.4) is not None      # not expired: placed
    req2 = _req(deadline_s=0.5)
    req2.t_arrival = 100.0
    assert r.dispatch(req2, now=100.6) is None         # past the deadline
    assert req2.done and req2.state is RequestState.EXPIRED
    assert req2.finish_reason == "deadline"
    assert req2.t_finished == 100.6
    assert r.shed == [req2]
    assert obs_metrics.counter("fleet.shed").value(reason="deadline") \
        - before == 1


def test_no_replica_shed_when_none_routable():
    replicas = _fleet([(0, 0), (0, 0)])
    replicas[0].state = ReplicaState.DRAINING
    replicas[1].state = ReplicaState.FAILED
    r = Router(replicas, policy="least-loaded")
    before = obs_metrics.counter("fleet.shed").value(reason="no_replica")
    req = _req()
    assert r.dispatch(req) is None
    assert req.done and req.state is RequestState.REJECTED
    assert req.finish_reason == "no_replica"
    assert obs_metrics.counter("fleet.shed").value(reason="no_replica") \
        - before == 1
    assert r.n_up == 0


def test_draining_replica_gets_no_new_work():
    replicas = _fleet([(0, 0), (0, 0)])
    r = Router(replicas, policy="round-robin")
    replicas[0].state = ReplicaState.DRAINING
    assert all(r.dispatch(_req()).idx == 1 for _ in range(3))
    assert not replicas[0].accepting
    assert replicas[1].accepting


def test_admission_gate_veto_skips_but_never_sheds():
    vetoed = []
    r = Router(_fleet([(0, 0), (0, 0)]), policy="round-robin",
               admission_gate=lambda h, req: not (
                   h.idx == 0 and not vetoed.append((h.idx, req.rid))))
    before = obs_metrics.counter("fleet.admission_rejects").total()
    assert r.dispatch(_req()).idx == 1   # r0 vetoed, fell through to r1
    assert len(vetoed) == 1
    assert obs_metrics.counter("fleet.admission_rejects").total() \
        - before == 1
    assert r.shed == []


# ------------------------------------------------- RequestQueue direct tests

def test_queue_peek_returns_head_without_removal():
    q = RequestQueue(max_queue=4)
    a, b = _req(), _req()
    q.submit(a, now=0.0)
    q.submit(b, now=0.0)
    assert q.peek(now=0.0) is a
    assert len(q) == 2                   # peek did not pop
    assert q.pop(now=0.0) is a           # peek-then-pop agree on the head
    assert q.peek(now=0.0) is b


def test_queue_peek_lazily_expires_overdue_heads():
    q = RequestQueue(max_queue=4)
    dead = _req(deadline_s=0.5)
    live = _req()
    q.submit(dead, now=0.0)
    q.submit(live, now=0.0)
    assert q.peek(now=1.0) is live       # dead expired in passing
    assert dead.state is RequestState.EXPIRED
    assert q.expired == [dead]
    assert len(q) == 1


def test_queue_peek_empty_returns_none():
    assert RequestQueue(max_queue=1).peek() is None


def test_queue_requeue_front_inserts_and_bypasses_bound():
    q = RequestQueue(max_queue=2)
    a, b, c = _req(), _req(), _req()
    q.submit(a, now=0.0)
    q.submit(b, now=0.0)
    c.state = RequestState.DECODING      # evacuated mid-flight
    q.requeue(c)
    assert len(q) == 3                   # over the bound, on purpose
    assert c.state is RequestState.QUEUED
    assert q.pop(now=0.0) is c           # front insert: redrives go first
    with pytest.raises(QueueFullError):  # submit backpressure still applies
        q.submit(_req(), now=0.0)


# ------------------------------------------- trace determinism (fleet scale)

def test_poisson_trace_is_prefix_stable():
    """trace(n)[:k] == trace(k): request content derives from (seed, i)
    only, so scaling trace length with replica count never changes what any
    request contains (the pre-fleet single-stream RNG broke this)."""
    kw = dict(rate_per_s=50.0, prompt_max=12, gen_max=5, vocab=97, seed=11)
    long = poisson_trace(9, **kw)
    for k in (1, 4, 9):
        short = poisson_trace(k, **kw)
        for (ta, pa, ga), (tb, pb, gb) in zip(long[:k], short):
            assert ta == tb and ga == gb
            np.testing.assert_array_equal(pa, pb)


def test_poisson_trace_prefix_pool_is_prefix_stable():
    kw = dict(rate_per_s=50.0, prompt_max=12, gen_max=5, vocab=97, seed=3,
              prefix_pool=2, prefix_len=4)
    long = poisson_trace(7, **kw)
    short = poisson_trace(3, **kw)
    for (ta, pa, ga), (tb, pb, gb) in zip(long[:3], short):
        assert ta == tb and ga == gb
        np.testing.assert_array_equal(pa, pb)
    # the shared prefixes really are shared: every prompt opens with one of
    # exactly two distinct 4-token prefixes
    heads = {tuple(p[:4]) for _, p, _ in long}
    assert len(heads) == 2


# ------------------------------------------- cross-check against the JAX one

def _seeded_run(fleet_mod, batching_mod, policy, seed):
    """A seeded sequence of dispatches, drains, failures, recoveries, queue
    pops and vetoes on stub replicas; returns what each dispatch gave."""
    rng = np.random.default_rng([seed, 21])
    handles = [fleet_mod.ReplicaHandle(
        i, _StubEngine(n_slots=2, occupied=int(rng.integers(0, 3)),
                       max_queue=int(rng.integers(1, 4)),
                       queue_cls=batching_mod.RequestQueue))
        for i in range(3)]
    vetoes = set()
    router = fleet_mod.Router(
        handles, policy=policy,
        admission_gate=lambda h, req: (h.idx, len(events)) not in vetoes)
    states = list(fleet_mod.ReplicaState)
    events = []
    for t in range(40):
        op = int(rng.integers(0, 10))
        if op in (0, 6, 7):
            h = handles[int(rng.integers(0, 3))]
            h.state = states[int(rng.integers(0, len(states)))]
        elif op <= 4:
            handles[int(rng.integers(0, 3))].engine.queue.pop(now=0.0)
        elif op == 5:
            vetoes.add((int(rng.integers(0, 3)), len(events)))
        deadline = 0.5 if rng.random() < 0.2 else None
        req = batching_mod.Request(prompt=np.ones(4, np.int32),
                                   max_new_tokens=2, deadline_s=deadline)
        req.t_arrival = 0.0
        now = float(rng.choice([0.1, 1.0]))
        h = router.dispatch(req, now=now)
        events.append((h.idx if h is not None else None, req.done,
                       req.finish_reason, req.state.value))
    return events, [r.finish_reason for r in router.shed], \
        router.n_dispatched


@pytest.mark.parametrize("policy", POLICIES)
def test_seeded_dispatch_sequence_equals_reference(policy):
    reasons = set()
    for seed in range(4):
        got = _seeded_run(tfleet, tbatching, policy, seed)
        assert got == _seeded_run(jfleet, jbatching, policy, seed)
        placed = [h for h, *_ in got[0] if h is not None]
        assert len(set(placed)) > 1                # the run really routes,
        assert any(h is None and not done          # defers,
                   for h, done, *_ in got[0])
        reasons |= set(got[1])                     # and sheds
    assert reasons == {"deadline", "no_replica"}
