"""What decides `correct`: a sound run passes, and the check comes out
false under the control and under each fault a cell can have, planted in
the timed path underneath a whole run (the look for a chip skipped: the
port's plain versions on the CPU)."""

import pytest

from conftest import small_segments

import control
from harness import check, main


def _run(root, workload="tiny.one", seed=31, ctl=None, ref_workers=1):
    res, lines = main.run(workload, seed, 0.5, False, device="cpu",
                          root=root, ref_workers=ref_workers, gen_workers=2,
                          control=ctl)
    assert lines == [f"check {k} {v['value']} limit 0"
                     for k, v in res["checks"].items()]
    return res


def _refine_unchanged(monkeypatch):
    from ribbit_tpu_torch import core
    monkeypatch.setattr(core.CoreSession, "refine",
                        lambda self, seeds, seq, sid: [])


def _half_left_out(monkeypatch):
    from ribbit_tpu_torch import eventstitch
    orig = eventstitch.merge_clipped
    monkeypatch.setattr(eventstitch, "merge_clipped",
                        lambda parts, nm: orig(parts[:len(parts) // 2], nm))


def _answer_altered(monkeypatch):
    from ribbit_tpu_torch import core
    orig = core.CoreSession.refine

    def refine(self, seeds, seq, sid):
        out = orig(self, seeds, seq, sid)
        if out:
            cols = out[0].split("\t")
            cols[2] = str(int(cols[2]) + 1)
            out[0] = "\t".join(cols)
        return out
    monkeypatch.setattr(core.CoreSession, "refine", refine)


@pytest.mark.parametrize("workload", ["tiny.one", "tiny.jobs",
                                      "tiny_recipe.jobs"])
def test_a_sound_run_is_correct(tiny_root, monkeypatch, workload):
    small_segments(monkeypatch)
    res = _run(tiny_root, workload)
    assert res["correct"], res["check_detail"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(d["lines"] > 0 for d in res["check_detail"])


@pytest.mark.parametrize("fault,number", [
    (_refine_unchanged, "bed_mismatch"),
    (_half_left_out, "events_mismatch"),
    (_answer_altered, "bed_mismatch"),
])
def test_a_fault_makes_the_run_incorrect(tiny_root, monkeypatch, fault,
                                         number):
    small_segments(monkeypatch)
    fault(monkeypatch)
    res = _run(tiny_root)
    assert not res["correct"]
    assert res["checks"][number]["value"] > 0


@pytest.mark.parametrize("ref_workers", [1, 2])
def test_the_control_fails_the_check(tiny_root, monkeypatch, ref_workers):
    """In one process and in the reference's worker processes alike."""
    small_segments(monkeypatch)
    res = _run(tiny_root, ctl=control.float16_lines, ref_workers=ref_workers)
    assert not res["correct"]
    assert res["checks"]["bed_mismatch"]["value"] > 0
    assert res["checks"]["events_mismatch"]["value"] == 0


def test_digests_see_every_change():
    import numpy as np
    s = (np.array([1, 5, 9, 2]), np.array([3, 7, 12, 4]),
         np.array([0, 3, 3, 4]))
    d = check.digests([s, s, s])
    assert d.shape == (3, 3, 2) and d[0, 1, 0] == 0
    for k in range(3):
        t = [a.copy() for a in s]
        t[0 if k < 2 else 1][k] += 1
        assert check.events_mismatch(check.digests([t, s, s]), d) == 1
    assert check.bed_mismatch(["a", "b"], ["b", "a"]) == 1
    assert check.bed_mismatch(["a", "b"], ["a"]) == 1
    assert check.bed_mismatch(["a"], ["a"]) == 0
