"""Each cell's loop and reference, run through the harness at a small size:
on the CPU with the kernels' plain versions, and on the card (marked
``cuda``) where the traced run's device metrics must read."""

import dataclasses

import pytest

import harness

# small sizes of each configuration; the widths of the rows stay. More
# rows than features, as at the cells' own sizes: with fewer, a float32
# fit leaves the float64 one within the 12 iterations the check follows.
SMALL = {
    "criteo1tb_logistic": {"rows": 8192, "features": 1 << 12},
    "glmix_ads_user": {"users": 512, "features": 1 << 12},
}
CELLS = [w["name"] for w in harness.load_json(f"{harness.ROOT}/BENCHMARK.json")["workloads"]]
# the warm-started grid: a traffic mix no cell lists yet (PERF.md section 7)
SEQUENTIAL = "criteo1tb_logistic.grid_sequential"


def small_cell(name, sizes=SMALL):
    if name == SEQUENTIAL:
        cell = dataclasses.replace(
            harness.find_cell("criteo1tb_logistic.grid_batched"), name=name,
            traffic_name="grid_sequential",
            traffic=harness.load_json(f"{harness.BENCH_DIR}/traffic/grid_sequential.json"))
    else:
        cell = harness.find_cell(name)
    return dataclasses.replace(cell, config={**cell.config, **sizes[cell.config_name]})


@pytest.mark.parametrize("cell", CELLS + [SEQUENTIAL])
def test_cpu_run_is_correct_and_reports_end_to_end(cell):
    c = small_cell(cell)
    out = harness.run_cell(c, 2**31 + 17, 0.01, False, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(c.limits)
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell", ["glmix_ads_user.cd_fit"])
def test_cpu_traced_run_reports_host_layers(cell):
    c = small_cell(cell)
    out = harness.run_cell(c, 23, 0.01, True, "cpu")
    assert out["correct"]
    # no device trace off the card: the device metrics are left out, not 0
    assert set(out["metrics"]) == {"schedule_build_s", "fe_update_s.fit", "re_update_s.fit"}
    assert out["device"]["window_s"] > 0 and "breakdown" in out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_traced_run_reads_every_metric(cell, cuda_device):
    c = small_cell(cell, {
        "criteo1tb_logistic": {"rows": 1 << 18},
        "glmix_ads_user": {"users": 8192},
    })
    out = harness.run_cell(c, 2**33 + 5, 1.0, True, cuda_device)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in c.per_layer}
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
    assert out["device"]["platform"] == "gpu" and 0 < out["device"]["busy_s"]
