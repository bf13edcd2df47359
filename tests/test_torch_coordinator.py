"""The port's coordinator state machine and DB against the reference's.

The transition table is the same; the reference's lifecycle, illegal
transition and random-walk checks hold in both packages; a DB written by
one package rehydrates in the other (its records are plain JSON).
"""
import dataclasses
import importlib

import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                        # bare env: seeded fallback
    from _hypothesis_fallback import given, settings, strategies as st

PKGS = ["repro", "repro_torch"]


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.ckpt"),
            importlib.import_module(f"{pkg}.core"),
            importlib.import_module(f"{pkg}.core.coordinator"))


def _asr(core):
    return core.ASR(name="t", n_vms=1, backend="x",
                    app_factory=lambda: core.SimulatedApp())


def test_transition_tables_equal():
    from repro.core.coordinator import TRANSITIONS as J
    from repro_torch.core.coordinator import TRANSITIONS as T
    as_names = lambda tab: {s.name: sorted(t.name for t in to)
                            for s, to in tab.items()}
    assert as_names(T) == as_names(J)
    assert [s.value for s in _mods("repro_torch")[1].CoordState] == \
        [s.value for s in _mods("repro")[1].CoordState]


@pytest.mark.parametrize("pkg", PKGS)
def test_legal_lifecycle(pkg):
    _, core, _ = _mods(pkg)
    S = core.CoordState
    db = core.CoordinatorDB()
    c = db.create(_asr(core))
    for s in (S.PROVISIONING, S.READY, S.RUNNING, S.SUSPENDED, S.RESTARTING,
              S.RUNNING, S.TERMINATING, S.TERMINATED):
        db.transition(c, s)
    assert [h[1] for h in c.history] == [
        "CREATING", "PROVISIONING", "READY", "RUNNING", "SUSPENDED",
        "RESTARTING", "RUNNING", "TERMINATING", "TERMINATED"]
    assert c.state == S.TERMINATED


@pytest.mark.parametrize("pkg", PKGS)
def test_illegal_transitions_raise(pkg):
    _, core, _ = _mods(pkg)
    db = core.CoordinatorDB()
    c = db.create(_asr(core))
    with pytest.raises(core.InvalidTransition):
        db.transition(c, core.CoordState.RUNNING)     # CREATING -> RUNNING
    db.transition(c, core.CoordState.PROVISIONING)
    with pytest.raises(core.InvalidTransition):
        db.transition(c, core.CoordState.SUSPENDED)


STATES = [s.name for s in _mods("repro")[1].CoordState]


@settings(max_examples=30, deadline=None)
@given(st.lists(st.sampled_from(STATES), min_size=1, max_size=12))
def test_random_walks_agree(walk):
    """The same random walk of transitions is accepted and refused at the
    same places in both packages, and leaves the same history."""
    outcomes = []
    for pkg in PKGS:
        _, core, coordinator = _mods(pkg)
        db = core.CoordinatorDB()
        c = db.create(_asr(core))
        seen = []
        for name in walk:
            prev, target = c.state, core.CoordState[name]
            try:
                db.transition(c, target)
                assert target in coordinator.TRANSITIONS[prev]
                seen.append(True)
            except core.InvalidTransition:
                assert c.state == prev
                seen.append(False)
        assert len(c.history) == sum(seen) + 1
        outcomes.append((seen, [h[1] for h in c.history]))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_db_written_by_one_package_rehydrates_in_the_other(writer, reader):
    wckpt, wcore, _ = _mods(writer)
    _, rcore, _ = _mods(reader)
    store = wckpt.InMemoryStore()
    db = wcore.CoordinatorDB(store)
    asr = dataclasses.replace(
        _asr(wcore), policy=wcore.CheckpointPolicy(
            period_s=0.5, codec="zlib", keep_last=7, swap_codec="int8"))
    a = db.create(asr)
    for s in ("PROVISIONING", "READY", "RUNNING"):
        db.transition(a, wcore.CoordState[s])
    a.metrics["last_recovery_s"] = 1.25
    db.transition(a, wcore.CoordState.SUSPENDED)
    b = db.create(_asr(wcore))

    loaded = {c.coord_id: c for c in rcore.CoordinatorDB(store).load()}
    assert set(loaded) == {a.coord_id, b.coord_id}
    ra = loaded[a.coord_id]
    assert ra.state == rcore.CoordState.SUSPENDED
    assert [s for _, s in ra.history] == ["CREATING", "PROVISIONING",
                                          "READY", "RUNNING", "SUSPENDED"]
    assert ra.vms == [] and ra.app is None
    assert (ra.asr.policy.codec, ra.asr.policy.keep_last,
            ra.asr.policy.period_s) == ("zlib", 7, 0.5)
    # the record keeps no swap codec, in either package: the policy comes
    # back as the writer's own package rehydrates it
    own = {c.coord_id: c for c in wcore.CoordinatorDB(store).load()}
    assert dataclasses.asdict(ra.asr.policy) == \
        dataclasses.asdict(own[a.coord_id].asr.policy)
    assert ra.metrics["last_recovery_s"] == 1.25
    assert ra.ckpt_prefix == a.ckpt_prefix
    assert ra.to_dict() == a.to_dict()
    with pytest.raises(RuntimeError, match="app_factory"):
        ra.asr.app_factory()
