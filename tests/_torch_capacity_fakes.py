"""Stub trainer and fleet for the capacity-controller tests: the surface
``CapacityController`` reads and drives, nothing else.  Shared by
``tests/test_torch_capacity.py`` (which runs the JAX package's and the
port's controllers over separate but identical stubs) and the rank side
``tests/_torch_elastic_ranks.py``; imports neither package."""

from types import SimpleNamespace


class FakeSLO:
    def __init__(self, owner):
        self.owner = owner
        self.targets = [SimpleNamespace(name="ttft")]
        self.resets = []

    def burn_rate(self, target, window_s):
        return self.owner.burn

    def reset_windows(self, epoch=None):
        self.resets.append(epoch)


class FakeEngine:
    def __init__(self, burn=0.0):
        self.burn = burn
        self.metrics = SimpleNamespace(slo=FakeSLO(self))


class FakeFleet:
    def __init__(self, n=2, clock=lambda: 0.0):
        self.clock = clock
        self.replicas = [FakeEngine() for _ in range(n)]
        self.draining = set()
        self.drain_done = True       # tests flip this for slow drains

    def _live(self):
        return [(i, e) for i, e in enumerate(self.replicas)
                if e is not None]

    def add_replica(self, engine):
        for j, e in enumerate(self.replicas):
            if e is None:
                self.replicas[j] = engine
                return j
        self.replicas.append(engine)
        return len(self.replicas) - 1

    def begin_drain(self, i):
        if self.replicas[i] is None:
            raise ValueError(f"replica {i} was removed")
        self.draining.add(i)

    def cancel_drain(self, i):
        self.draining.discard(i)

    def drained(self, i):
        return self.drain_done

    def remove_replica(self, i):
        eng = self.replicas[i]
        self.replicas[i] = None
        self.draining.discard(i)
        return eng

    def set_burn(self, burn):
        for _, e in self._live():
            e.burn = burn


class FakeTrainer:
    """``spec_cls`` is the package's ``TopologySpec``."""

    def __init__(self, spec_cls, dp=4):
        self.plan = SimpleNamespace(spec=spec_cls(dp=dp))
        self.stats = {"last_checkpoint_s": 0.0, "last_reshard_s": 0.0}
        self.current_step = 0
        self.replans = []

    def replan_to(self, spec, *, checkpoint_first=True):
        self.replans.append(spec.dp)
        self.plan = SimpleNamespace(spec=spec)
