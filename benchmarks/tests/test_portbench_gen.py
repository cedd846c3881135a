"""The generator and the traffic plan are fixed by the seed, and a
configuration's recipe changes only what it states."""

import hashlib

import pytest

from harness import gen, spec, traffic

# sha256 of traffic.sequence for the first two planned records (the
# warm-up and the first record) of each cell at seed 3141592701, as the
# harness generated them before configurations could state a recipe: the
# cells' inputs may never change.
CELL_DIGESTS = {
    "hg38_default.chromosomes": [
        "3e322e5f796764f5a35827aa2b01fb3cb56abcee350b5a2aa27293dab4a85870",
        "e3dae5bb111baf4ed26737860a91a7b6dc1d38e87ee317719c6ee2a3be890ee8"],
    "r64_default.per_chromosome": [
        "78dd0751cbc5c1cbc3f4f30f12819194aea5e66a7d3d35ebd92ac09c02d05fdf",
        "ea3f8e7e1fb5a8fcc2514922ab0ac7bda99ebe13488fdd46094c9bece83a866c"],
    "r64_default.genomes": [
        "78dd0751cbc5c1cbc3f4f30f12819194aea5e66a7d3d35ebd92ac09c02d05fdf",
        "ea3f8e7e1fb5a8fcc2514922ab0ac7bda99ebe13488fdd46094c9bece83a866c"],
}
DEFAULT_RECIPE = {"motif_bp": [2, 100]}


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
            assert got[r.name] == traffic.sequence(r, config)


@pytest.mark.parametrize("recipe", [None, DEFAULT_RECIPE],
                         ids=["no_recipe", "default_recipe"])
@pytest.mark.parametrize("workload", sorted(CELL_DIGESTS))
def test_cells_inputs_are_pinned(workload, recipe):
    cell = spec.load_cell(workload)
    config = dict(cell.config)
    assert "recipe" not in config
    if recipe is not None:
        config["recipe"] = recipe
    recs = traffic.plan(config, cell.traffic, 3141592701)[:2]
    got = [hashlib.sha256(traffic.sequence(r, config).encode()).hexdigest()
           for r in recs]
    assert got == CELL_DIGESTS[workload]


def _motif_sizes(monkeypatch, config):
    """The planted motif sizes of one 300 kb record made from config."""
    sizes = []
    orig = gen._random_motif

    def spy(rng, size):
        sizes.append(size)
        return orig(rng, size)
    with monkeypatch.context() as m:
        m.setattr(gen, "_random_motif", spy)
        traffic.sequence(traffic.Record("x", 300000, 5), config)
    return sizes


def test_recipe_bounds_the_planted_motifs(monkeypatch):
    sizes = _motif_sizes(monkeypatch, {"n_block_rate": 0.1,
                                       "recipe": {"motif_bp": [150, 300]}})
    assert len(sizes) > 50
    assert min(sizes) >= 150 and max(sizes) <= 300
    # the bounds are reached, not only kept
    assert min(sizes) < 170 and max(sizes) > 280
    sizes = _motif_sizes(monkeypatch, {"n_block_rate": 0.1})
    assert min(sizes) >= 2 and max(sizes) <= 100 and max(sizes) > 90


@pytest.mark.parametrize("recipe", [
    {"motifs": [2, 300]},
    {"motif_bp": [2, 300], "spacer_bp": [125, 750]},
    {"spacer": "iid"},
    {"motif_bp": [300, 2]},
    {"motif_bp": [1, 100]},
    {"motif_bp": [2.0, 300]},
])
def test_a_bad_recipe_raises_as_the_run_is_planned(recipe):
    config = {"records": [{"name": "x", "length": 1000}],
              "n_block_rate": 0.1, "recipe": recipe}
    t = {"warmup": {"length": 300}, "pass_bp": 2000}
    with pytest.raises(ValueError):
        traffic.plan(config, t, 1)
    with pytest.raises(ValueError):
        traffic.sequence(traffic.Record("x", 1000, 1), config)
