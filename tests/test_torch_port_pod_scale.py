"""``primekg_rgcn_tpu_torch/bench/pod_scale.py`` on the CPU at about 20k
nodes, 200k edges and 50 relations (config 5's relation count; its scale
cut 500-fold), against the JAX package on the same graph: the node
partition's fields and the byte model equal to what the JAX
``partition_nodes`` and ``comms_bytes_model`` give, one node-sharded adam
step and zero3 steps at both table rules with finite losses, and zero3's
byte model equal to the JAX module's formula. No JAX step is compiled:
only the JAX partitioner, byte model and sampler budgets run."""

import json

import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.bench import scaling as jscaling
from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.data.sampling import _unique_cap as j_unique_cap
from primekg_rgcn_tpu.parallel.node_shard import \
    partition_nodes as j_partition
from primekg_rgcn_tpu.train.sampled import \
    resolve_sampler as j_resolve_sampler
from primekg_rgcn_tpu_torch.bench import pod_scale, suite

SIZE = (20_000, 200_000, 50)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_graph():
    _, edges, _ = suite.rmat_rel_graph(*SIZE)
    return j_build(edges[:, 0], edges[:, 1], edges[:, 2], SIZE[0], SIZE[2])


@pytest.fixture(scope="module")
def node_report():
    return pod_scale.run_pod_scale(*SIZE, n_devices=4, batch_size=256,
                                   device="cpu")


def test_node_partition_fields_equal_jax(node_report, jax_graph):
    sg = j_partition(jax_graph, 4)
    assert node_report["halo_width"] == int(sg.halo_width)
    assert node_report["n_loc"] == int(sg.n_loc)
    assert node_report["e_local_cap"] == int(sg.offsets_local[-1])
    assert node_report["e_halo_cap"] == int(sg.offsets_halo[-1])
    assert node_report["halo_width"] > 0


def test_node_report_counts_the_buckets_its_launches_follow(node_report,
                                                            jax_graph):
    """The (shard, group, relation) buckets with real edges, as the JAX
    partition of the same graph holds them; the CPU launches no kernel."""
    sg = j_partition(jax_graph, 4)

    def with_edges(dst, offsets):
        # A (shard, relation) bucket's slots past its real edges hold n_loc.
        dst = np.asarray(dst)
        return sum(bool((dst[d, offsets[r]:offsets[r + 1]] < sg.n_loc).any())
                   for d in range(4) for r in range(SIZE[2]))

    halo = with_edges(sg.dst_halo, sg.offsets_halo)
    local = with_edges(sg.dst_local, sg.offsets_local)
    assert node_report["halo_buckets_with_edges"] == halo > 0
    assert node_report["buckets_with_edges"] == local + halo
    assert node_report["uniform_caps"] is bool(sg.uniform_caps)
    assert node_report["launches"] == {"B1": 0, "B2": 0, "B3": 0, "B4": 0}


def test_host_peak_is_the_process_high_water_mark():
    """The peak keeps a freed high-water mark (the kernel's counters lag
    the resident set by a few pages' batches: 50 MiB of slack)."""
    def rss_gb():
        with open("/proc/self/status") as f:
            return int(f.read().split("VmRSS:")[1].split()[0]) / 2 ** 20

    big = np.ones(40_000_000)  # 305 MiB touched
    high = rss_gb()
    del big
    assert pod_scale.peak_host_rss_gb() >= high - 0.05 > rss_gb() + 0.2


def test_node_comms_model_equals_jax(node_report, jax_graph):
    theirs = jscaling.comms_bytes_model(
        jax_graph, JModelConfig(num_nodes=SIZE[0], num_relations=SIZE[2]),
        4, batch_size=256)
    assert json.dumps(node_report["comms_model"], sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)


def test_node_step_runs_and_reckons_its_bytes(node_report):
    assert np.isfinite(node_report["loss"]) and 0 <= node_report["acc"] <= 1
    assert node_report["step_ms"] > 0
    assert node_report["peak_host_rss_gb"] > 0
    rk = node_report["node_step_bytes"]
    n, p = 4, node_report["halo_width"]
    n_loc = node_report["n_loc"]
    assert rk["rowptr_local"] == n * SIZE[2] * (n_loc + 2) * 4
    assert rk["t_rowptr_halo"] == n * SIZE[2] * (n * p + 2) * 4
    assert rk["halo_layer2"] == 4 * n * n * p * 128 * 4
    assert rk["params_grads_adam"] == 16 * (
        SIZE[0] * 64 + pod_scale._rest_params(suite_cfg()))
    assert rk["total"] == sum(v for k, v in rk.items() if k != "total")


def suite_cfg():
    from primekg_rgcn_tpu_torch.config import ModelConfig

    return ModelConfig(num_nodes=SIZE[0], num_relations=SIZE[2])


@pytest.mark.parametrize("table_opt", ["sgd", "adafactor"])
def test_zero3_step_and_its_comms_model(table_opt, jax_graph):
    rep = pod_scale.run_pod_scale_zero3(*SIZE, n_devices=8, batch_size=256,
                                        table_opt=table_opt, device="cpu")
    assert rep["mode"] == ("sampled-zero3-adafactor" if table_opt ==
                           "adafactor" else "sampled-zero3-adam")
    assert np.isfinite(rep["loss"]) and rep["step_ms"] > 0
    # The JAX module's formula (pod_scale.py:548-566) on the JAX sampler's
    # budgets for the same graph.
    _, budgets, comb = j_resolve_sampler(jax_graph, (15, 10))
    assert rep["budgets"] == list(budgets)
    assert rep["layout"] == ("combined" if comb else "per-relation")
    cap = j_unique_cap(2 * (256 // 8) * 2, SIZE[0])
    for f in budgets:
        cap = j_unique_cap(cap * (1 + (int(f) if comb else int(f) * 50)),
                           SIZE[0])
    model = rep["zero3_comms_model"]
    assert model["frontier_cap"] == cap
    assert model["ids_allgather_bytes"] == 8 * cap * 4
    assert model["rows_psum_scatter_bytes"] == 8 * cap * 64 * 4
    assert model["cotangent_allgather_bytes"] == 8 * cap * 64 * 4
    assert rep["table_slice_mb"] == -(-SIZE[0] // 8) * 64 * 4 / 2 ** 20


def test_main_partition_only_merges_its_tag(tmp_path):
    out = tmp_path / "r.json"
    rep = pod_scale.main(["--nodes", "20000", "--edges", "200000",
                          "--relations", "50", "--devices", "4",
                          "--partition_only", "--device", "cpu",
                          "--tag", "pod", "--out", str(out)])
    assert "step_ms" not in rep and rep["note"].startswith("step skipped")
    saved = json.loads(out.read_text())["results"]["pod"]
    assert saved["halo_width"] == rep["halo_width"]
    assert "node_step_bytes" in saved
