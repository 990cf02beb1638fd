"""The port's fleet under injected faults: the no-loss / no-duplicate
contract, on the CPU (counterpart of ``tests/fleet/test_fleet_faults.py``,
with the port of its harness, ``tests/fleet/faults.py``).

A :class:`FaultPlan` is a *schedule*, not a dice roll at runtime: every
fault it describes is derived once from a seed (``FaultPlan.from_seed``)
and then replayed against a **lockstep** :class:`~repro_torch.serving.
fleet.FleetDriver`, so a failing seed reproduces exactly — same kill step,
same handoff delays, same admission vetoes.  Three fault classes:

* ``kills[idx] = K`` — fail replica ``idx`` once *its engine* has taken
  ``K`` decode steps (``ContinuousEngine.n_decode_steps``), i.e. mid
  decode with real tokens already generated.
* ``handoff_delays[j] = d`` — the ``j``-th prefill→decode payload sits on
  the wire for ``d`` extra pumps (installed as the coordinator's
  ``transport``).
* ``admission_rejects = M`` — the router's ``admission_gate`` vetoes the
  first ``M`` (replica, request) placement attempts.

:class:`FaultHarness` installs a plan on a driver and drives it to drain,
raising ``TimeoutError`` on a step bound or on a step that moved nothing
and left the fleet's observable state unchanged.

Every scenario asserts the invariants that make failures invisible to
callers: **no drop** (every request finishes, or sheds for a declared
reason with the matching ``fleet.shed{reason}`` count), **no duplicate**
(each rid finishes once, fleet-wide) and **bit-identity** (outputs equal
the port's single engine even when the tokens were generated twice).
Reduced qwen3-1.7b, weights from ``jax.random.PRNGKey(0)`` crossed to the
port.  Three checks hold the port to the JAX package: its plans equal the
reference harness's for seeds 0–7, the requests one plan evacuates are
the reference fleet's, and a paged kill returns every pool block.
"""
import dataclasses
import time
from typing import Dict, List, Set

import jax
import numpy as np
import pytest
import torch

from fleet.faults import FaultHarness as JHarness
from fleet.faults import FaultPlan as JPlan
from repro.configs import registry as jreg
from repro.models import api as japi
from repro.serving import engine as jengine
from repro.serving.fleet import FleetDriver as JFleet
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.core.spec import KVCompressionSpec
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving import engine as serving_engine
from repro_torch.serving.batching import (ContinuousEngine, QueueFullError,
                                          Request)
from repro_torch.serving.fleet import FleetDriver

CPU = torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seed-derived fault schedule (see module docstring for semantics)."""
    kills: Dict[int, int] = dataclasses.field(default_factory=dict)
    handoff_delays: Dict[int, int] = dataclasses.field(default_factory=dict)
    admission_rejects: int = 0

    @classmethod
    def from_seed(cls, seed: int, *, n_replicas: int,
                  kill: bool = True, kill_after: int = 5,
                  n_delayed: int = 0, max_delay: int = 3,
                  max_rejects: int = 0) -> "FaultPlan":
        """Derive a plan from ``seed`` (stable across runs and platforms).

        ``kill`` picks ONE victim replica (a plan never kills the whole
        fleet — total loss of capacity is the ``no_replica`` shed test's
        job, not a redrive scenario)."""
        rng = np.random.default_rng([int(seed), 0xFA])
        kills: Dict[int, int] = {}
        if kill and n_replicas > 1:
            kills[int(rng.integers(n_replicas))] = \
                int(rng.integers(1, kill_after + 1))
        delays = {j: int(rng.integers(1, max_delay + 1))
                  for j in range(n_delayed)}
        rejects = int(rng.integers(1, max_rejects + 1)) if max_rejects else 0
        return cls(kills=kills, handoff_delays=delays,
                   admission_rejects=rejects)


class FaultHarness:
    """Install a :class:`FaultPlan` on a lockstep driver and run it dry."""

    def __init__(self, driver: FleetDriver, plan: FaultPlan):
        self.driver = driver
        self.plan = plan
        self.rejects_left = plan.admission_rejects
        self.n_rejected = 0               # vetoes actually exercised
        self.n_handoffs = 0               # payloads seen by the transport
        self.victims: List[Request] = []  # evacuated by triggered kills
        self.n_steps = 0
        self._killed: Set[int] = set()
        if plan.admission_rejects:
            driver.router.admission_gate = self._gate
        if plan.handoff_delays:
            if driver.handoff is None:
                raise ValueError("plan delays handoffs but the driver is "
                                 "not disaggregated")
            driver.handoff.transport = self._transport

    # ------------------------------------------------------------ fault hooks
    def _gate(self, handle, req) -> bool:
        if self.rejects_left > 0:
            self.rejects_left -= 1
            self.n_rejected += 1
            return False
        return True

    def _transport(self, payload) -> int:
        d = self.plan.handoff_delays.get(self.n_handoffs, 0)
        self.n_handoffs += 1
        return d

    def _maybe_kill(self) -> None:
        for idx, after in self.plan.kills.items():
            if idx in self._killed:
                continue
            if self.driver.replicas[idx].engine.n_decode_steps >= after:
                self._killed.add(idx)
                self.victims.extend(self.driver.kill_replica(idx))

    # ------------------------------------------------------------------ drive
    def _fingerprint(self) -> tuple:
        d = self.driver
        return (len(d.intake), self.rejects_left,
                d.handoff.pending if d.handoff is not None else 0,
                tuple(h.engine.n_decode_steps for h in d.replicas),
                len(d.finished), len(d.shed), tuple(sorted(self._killed)))

    def run(self, max_steps: int = 5000) -> List[Request]:
        """Lockstep the fleet to drain, firing plan kills between steps.

        Raises ``TimeoutError`` on the step bound or on a no-progress step
        that also left the fleet state fingerprint unchanged (stuck, not
        merely quiet — e.g. an admission veto changes the gate budget, so
        a deferred-but-retrying request never trips this)."""
        prev = None
        while self.driver.has_work:
            moved = self.driver.step()
            self._maybe_kill()
            self.n_steps += 1
            if self.n_steps >= max_steps:
                raise TimeoutError(
                    f"fleet not drained after {max_steps} steps: "
                    f"{self._fingerprint()}")
            fp = self._fingerprint()
            if not moved and fp == prev and self.driver.has_work:
                raise TimeoutError(f"fleet stuck (no progress): {fp}")
            prev = fp
        return self.driver.finished


MAX_LEN = 48


@pytest.fixture(scope="module")
def weights():
    """The reference's config and weights, and the port's (crossed as
    numpy arrays)."""
    jcfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    return jcfg, jp, cfg, convert.params_from_numpy(cfg, host, "cpu")


@pytest.fixture(scope="module")
def harness(weights, rng_seed):
    _, _, cfg, params = weights
    sc = serving_engine.ServeConfig(max_len=MAX_LEN)
    eng = serving_engine.Engine(cfg, params, sc, device="cpu")
    return cfg, params, sc, eng, rng_seed


def _jobs(cfg, seed, n=6, gen_min=6, gen_max=9):
    rng = np.random.default_rng([seed, 7])
    return [(rng.integers(0, cfg.vocab,
                          (int(rng.integers(5, 21)),)).astype(np.int32),
             int(rng.integers(gen_min, gen_max + 1)))
            for _ in range(n)]


def _refs(eng, jobs):
    return [np.asarray(eng.generate(np.asarray(p)[None], g))[0].tolist()
            for p, g in jobs]


def _driver(cfg, params, sc, eng, **kw):
    kw.setdefault("n_replicas", 3)
    kw.setdefault("n_slots", 2)
    kw.setdefault("prefill_chunk", 4)
    return FleetDriver(cfg, params, sc, steps=eng.steps, devices=[CPU], **kw)


# ------------------------------------------------------------------- kills

def test_kill_replica_mid_decode_no_loss_no_duplicate(harness):
    cfg, params, sc, eng, seed = harness
    jobs = _jobs(cfg, seed)
    refs = _refs(eng, jobs)
    plan = FaultPlan.from_seed(seed, n_replicas=3, kill=True, kill_after=5)
    fd = _driver(cfg, params, sc, eng, policy="round-robin")
    h = FaultHarness(fd, plan)
    redrives0 = obs_metrics.counter("fleet.redrives").total()
    rids = [fd.submit(p, g).rid for p, g in jobs]
    fin = {r.rid: r for r in h.run()}

    # gens >= 6 and a kill threshold <= 5 guarantee the victim replica was
    # still decoding when it died — the kill really fired mid-stream
    assert h.victims, f"plan {plan} never triggered"
    assert sorted(fin) == sorted(rids)               # no drop, no duplicate
    assert len(fd.finished) == len(jobs)
    assert fd.shed == []
    assert [fin[r].output for r in rids] == refs     # bit-identity across kill
    for v in h.victims:
        assert v.redrives == 1
        assert fin[v.rid] is v                       # same object, re-finished
    assert obs_metrics.counter("fleet.redrives").total() - redrives0 \
        == len(h.victims)
    # no victim re-finished on the dead replica (redrive went elsewhere)
    dead = next(iter(plan.kills))
    assert not ({v.rid for v in h.victims}
                & {r.rid for r in fd.replicas[dead].engine.finished})


# -------------------------------------------------------- admission rejects

def test_admission_rejects_requeue_without_loss(harness):
    cfg, params, sc, eng, seed = harness
    jobs = _jobs(cfg, seed, n=5)
    refs = _refs(eng, jobs)
    plan = FaultPlan.from_seed(seed, n_replicas=3, kill=False, max_rejects=5)
    assert plan.admission_rejects >= 1
    fd = _driver(cfg, params, sc, eng, policy="least-loaded")
    h = FaultHarness(fd, plan)
    rejects0 = obs_metrics.counter("fleet.admission_rejects").total()
    rids = [fd.submit(p, g).rid for p, g in jobs]
    fin = {r.rid: r for r in h.run()}

    assert h.n_rejected == plan.admission_rejects    # whole budget exercised
    assert obs_metrics.counter("fleet.admission_rejects").total() - rejects0 \
        == plan.admission_rejects
    assert sorted(fin) == sorted(rids)
    assert fd.shed == []                             # vetoes defer, never drop
    assert [fin[r].output for r in rids] == refs


# ----------------------------------------------------------- handoff delays

def test_delayed_handoff_delivers_bit_identical(harness):
    cfg, params, sc, eng, seed = harness
    kv_spec = KVCompressionSpec.parse("bits=16,block=8")
    jobs = _jobs(cfg, seed, n=4)
    ref_ce = ContinuousEngine(cfg, params, sc, n_slots=2, prefill_chunk=4,
                              steps=eng.steps, kv_spec=kv_spec, device="cpu")
    ref_rids = [ref_ce.submit(p, g).rid for p, g in jobs]
    ref_fin = {r.rid: r for r in ref_ce.run()}
    refs = [ref_fin[r].output for r in ref_rids]

    plan = FaultPlan.from_seed(seed, n_replicas=2, kill=False,
                               n_delayed=3, max_delay=4)
    fd = _driver(cfg, params, sc, eng, n_replicas=2, disaggregate=(1, 1),
                 kv_spec=kv_spec)
    h = FaultHarness(fd, plan)
    rids = [fd.submit(p, g).rid for p, g in jobs]
    fin = {r.rid: r for r in h.run()}

    assert h.n_handoffs == len(jobs)                 # transport saw each one
    assert fd.handoff.n_delivered == len(jobs)
    assert fd.handoff.pending == 0
    assert sorted(fin) == sorted(rids)
    assert [fin[r].output for r in rids] == refs
    # prefill replicas never decode; decode replica did all the tokens
    assert fd.replicas[0].engine.n_decode_steps == 0
    assert sum(len(r.output) for r in fd.replicas[1].engine.finished) \
        == sum(len(o) for o in refs)


# ------------------------------------------------------- shed{reason} counts

def test_shed_deadline_metric_exact(harness):
    cfg, params, sc, eng, seed = harness
    fd = _driver(cfg, params, sc, eng, n_replicas=1)
    before = obs_metrics.counter("fleet.shed").value(reason="deadline")
    req = fd.submit(np.ones(6, np.int32), 4, deadline_s=1e-6)
    time.sleep(0.01)
    fd.run()
    assert req.finish_reason == "deadline"
    assert req in fd.shed
    assert fd.finished == []
    assert obs_metrics.counter("fleet.shed").value(reason="deadline") \
        - before == 1


def test_shed_queue_full_metric_exact(harness):
    cfg, params, sc, eng, seed = harness
    fd = _driver(cfg, params, sc, eng, n_replicas=1, max_intake=2)
    before = obs_metrics.counter("fleet.shed").value(reason="queue_full")
    fd.submit(np.ones(6, np.int32), 3)
    fd.submit(np.ones(6, np.int32), 3)
    with pytest.raises(QueueFullError):
        fd.submit(np.ones(6, np.int32), 3)
    assert obs_metrics.counter("fleet.shed").value(reason="queue_full") \
        - before == 1
    assert len(fd.shed) == 1 and fd.shed[0].finish_reason == "queue_full"
    assert len(fd.run()) == 2                        # survivors still finish


def test_shed_no_replica_metric_exact(harness):
    cfg, params, sc, eng, seed = harness
    fd = _driver(cfg, params, sc, eng, n_replicas=2)
    fd.kill_replica(0)
    fd.kill_replica(1)
    before = obs_metrics.counter("fleet.shed").value(reason="no_replica")
    req = fd.submit(np.ones(6, np.int32), 4)
    fd.run()
    assert req.finish_reason == "no_replica"
    assert req in fd.shed
    assert obs_metrics.counter("fleet.shed").value(reason="no_replica") \
        - before == 1


# ---------------------------------------------------------------- draining

def test_draining_finishes_in_flight_but_accepts_nothing(harness):
    cfg, params, sc, eng, seed = harness
    jobs = _jobs(cfg, seed, n=6, gen_min=3, gen_max=5)
    fd = _driver(cfg, params, sc, eng, policy="round-robin")
    first = [fd.submit(p, g) for p, g in jobs[:3]]
    fd.pump()                                        # place on all 3 replicas
    drained = fd.drain_replica(0)
    # nothing has stepped yet, so replica 0's share is still in its queue
    in_flight_on_0 = {r.rid for r in fd.replicas[0].engine.queue._q}
    assert in_flight_on_0                            # round-robin gave it work
    late = [fd.submit(p, g) for p, g in jobs[3:]]
    fin = {r.rid: r for r in fd.run()}
    assert sorted(fin) == sorted(r.rid for r in first + late)  # nobody lost
    done_on_0 = {r.rid for r in fd.replicas[0].engine.finished}
    assert in_flight_on_0 <= done_on_0               # drained work finished
    assert not done_on_0 & {r.rid for r in late}     # nothing new accepted
    assert drained.accepting is False


# ------------------------------------------------------------ plan derivation

def test_fault_plan_seed_deterministic():
    mk = lambda s: FaultPlan.from_seed(s, n_replicas=3, n_delayed=2,
                                       max_rejects=5)
    assert mk(3) == mk(3)
    assert any(mk(a) != mk(b) for a, b in [(0, 1), (1, 2), (2, 3)])


def test_harness_raises_on_stuck_fleet(harness):
    cfg, params, sc, eng, seed = harness
    fd = _driver(cfg, params, sc, eng, n_replicas=1)
    # a gate that vetoes forever wedges dispatch; the harness must detect
    # the unchanged fingerprint and raise instead of spinning to max_steps
    fd.router.admission_gate = lambda h, r: False
    fd.submit(np.ones(6, np.int32), 3)
    with pytest.raises(TimeoutError, match="stuck"):
        FaultHarness(fd, FaultPlan()).run(max_steps=50)


# ------------------------------------------------ against the JAX package

def test_fault_plan_from_seed_equals_reference():
    for seed in range(8):
        for kw in (dict(n_replicas=3), dict(n_replicas=2, kill=False,
                                             n_delayed=3, max_delay=4),
                   dict(n_replicas=3, n_delayed=2, max_rejects=5)):
            got = FaultPlan.from_seed(seed, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                JPlan.from_seed(seed, **kw))


def test_evacuated_requests_equal_reference(weights, harness):
    """One kill plan against both packages' fleets on the same jobs: the
    same requests (by submission index) are evacuated, and every one
    finishes once with the reference's token count."""
    jcfg, jp, cfg, params = weights
    _, _, sc, eng, seed = harness
    jobs = _jobs(cfg, seed)
    plan = FaultPlan.from_seed(seed, n_replicas=3, kill=True, kill_after=5)
    jsc = jengine.ServeConfig(max_len=MAX_LEN)
    runs = []
    for fd, harness_cls, p in (
            (_driver(cfg, params, sc, eng, policy="round-robin"),
             FaultHarness, plan),
            (JFleet(jcfg, jp, jsc, steps=jengine.Engine(jcfg, jp, jsc).steps,
                    n_replicas=3, n_slots=2, prefill_chunk=4,
                    policy="round-robin"), JHarness,
             JPlan(**dataclasses.asdict(plan)))):
        h = harness_cls(fd, p)
        reqs = [fd.submit(prompt, g) for prompt, g in jobs]
        fin = h.run()
        index = {r.rid: i for i, r in enumerate(reqs)}
        runs.append((sorted(index[v.rid] for v in h.victims),
                     sorted(index[r.rid] for r in fin),
                     [len(r.output) for r in reqs], h.n_steps))
    assert runs[0] == runs[1]
    assert runs[0][0] and runs[0][1] == list(range(len(jobs)))


def test_paged_kill_leaks_no_block(harness):
    """A paged replica with prefix sharing killed mid-prefill and
    mid-decode: its free blocks plus its refcount-0 LRU return to their
    count before admission, no block is on the free list twice, and the
    redriven requests still finish bitwise the single paged engine."""
    cfg, params, sc, eng, seed = harness
    kv_spec = KVCompressionSpec.parse("bits=16,block=4,sharing")
    prefix = np.random.default_rng([seed, 3]).integers(
        0, cfg.vocab, (8,)).astype(np.int32)
    jobs = [(np.concatenate([prefix, p]), g) for p, g in _jobs(cfg, seed)]
    ref = ContinuousEngine(cfg, params, sc, n_slots=2, prefill_chunk=4,
                           steps=eng.steps, kv_spec=kv_spec, device="cpu")
    ref_reqs = [ref.submit(p, g) for p, g in jobs]
    ref.run()
    fd = _driver(cfg, params, sc, eng, n_replicas=2, kv_spec=kv_spec,
                 policy="round-robin", admit_chunks_per_step=1)
    victim = fd.replicas[0].engine.slots
    free0 = victim.n_free_blocks + len(victim._lru)
    reqs = [fd.submit(p, g) for p, g in jobs]
    while fd.replicas[0].engine.n_decode_steps < 2:
        fd.step()
    eng0 = fd.replicas[0].engine
    states = {r.state.value for r in eng0.slots.requests if r is not None}
    assert eng0._prefilling is not None and states == {"prefilling",
                                                       "decoding"}
    assert len(victim._refs) > 0 and any(victim._slot_shared)
    victims = fd.kill_replica(0)
    assert len(victims) >= 2
    assert victim.n_free_blocks + len(victim._lru) == free0
    assert len(set(victim._free_blocks)) == len(victim._free_blocks)
    assert not any(victim._slot_private) and not any(victim._slot_shared)
    assert all(n == 0 for n in victim._refs.values())
    fin = {r.rid: r for r in fd.run()}
    assert sorted(fin) == sorted(r.rid for r in reqs)
    assert [fin[r.rid].output for r in reqs] == [r.output for r in ref_reqs]
