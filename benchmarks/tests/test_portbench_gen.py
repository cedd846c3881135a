"""The generator and the traffic plan are fixed by the seed."""

import hashlib

from harness import gen, traffic


def test_generator_is_pinned_and_deterministic():
    a = gen.simulate_length(50000, 12345)
    assert len(a) == 50000
    assert a == gen.simulate_length(50000, 12345)
    assert a != gen.simulate_length(50000, 12346)
    # the yardstick: this sequence may never change
    assert hashlib.sha256(a.encode()).hexdigest()[:32] == \
        "8a63c9139e03cb2d63d57203a407beda"
    assert set(a) <= set("ACGTN") and "N" in gen.simulate_length(400000, 1)


def test_simulate_length_is_the_recipe_cut():
    s = gen.simulate(num_loci=40, seed=11, n_block_rate=0.1).sequence
    assert gen.simulate_length(len(s), 11) == s


def test_plan_is_seeded_and_sized():
    config = {"records": [{"name": "x", "length": 1000},
                          {"name": "y", "length": 500}]}
    t = {"warmup": {"record": "y"}, "pass_bp": 3200}
    p = traffic.plan(config, t, 2 ** 33 + 5)
    assert [r.name for r in p] == ["y_warmup", "x_1", "y_1", "x_2", "y_2",
                                   "x_3", "y_3"]
    assert len({r.seed for r in p}) == len(p)
    q = traffic.plan(config, t, 2 ** 33 + 5)
    assert [r.seed for r in p] == [r.seed for r in q]
    assert traffic.plan(config, t, 7)[1].seed != p[1].seed


def test_files_hold_the_records(tmp_path):
    config = {"records": [{"name": "x", "length": 1234},
                          {"name": "y", "length": 81}],
              "n_block_rate": 0.1}
    for layout in ("one_fasta", "per_record"):
        d = tmp_path / layout
        d.mkdir()
        t = {"warmup": {"length": 300}, "pass_bp": 2000, "layout": layout}
        recs = traffic.plan(config, t, 99)
        files = traffic.layout(recs, t, d)
        pool, futs = traffic.start_writing(recs, config, workers=2)
        for f in futs:
            f.result()
        pool.shutdown()
        text = "".join(open(f).read() for f in files)
        got = {}
        for block in text.split(">")[1:]:
            name, *rows = block.split("\n")
            got[name] = "".join(rows)
        assert list(got) == [r.name for r in recs]
        for r in recs:
            assert got[r.name] == traffic.sequence(r, 0.1)
