"""The analysis slice: the port's ``analyze/`` against the JAX package's, on
one tiny kg.csv preprocessed and trained (2 epochs, width 8) by the port's
CLIs on the CPU.

Both contexts load the same ``best_model.pt``; their embeddings agree within
rtol 2e-4, atol 2e-5. Each tool is then compared on the same embeddings (the
JAX context's, handed to the port's context): every JSON, CSV and text
output equal after parsing numbers, within 1e-9, except the AUC-ROC of the
method comparison, which the port counts in float64 and the JAX package in
float32 (held within 1e-7, one float32 step at 1). ``find_paths`` is equal
list for list to networkx's, on the fixture graph and on random graphs with
two hubs. The orchestrator runs all eight analyses in-process, a subset in
subprocesses, and isolates an analysis that raises.
"""

import csv
import itertools
import json
import re
from pathlib import Path

import networkx as nx
import numpy as np
import pytest

from primekg_rgcn_tpu.analyze import analyze_failures as j_fail
from primekg_rgcn_tpu.analyze import case_studies as j_case
from primekg_rgcn_tpu.analyze import compare_methods as j_cmp
from primekg_rgcn_tpu.analyze import error_analysis as j_err
from primekg_rgcn_tpu.analyze import explain_predictions as j_expl
from primekg_rgcn_tpu.analyze import medical_validation as j_val
from primekg_rgcn_tpu.analyze import run_full_analysis as j_run
from primekg_rgcn_tpu.analyze import visualize_embeddings as j_viz
from primekg_rgcn_tpu.analyze.core import AnalysisContext as JContext
from primekg_rgcn_tpu.data import artifacts as jart
from primekg_rgcn_tpu_torch.analyze import analyze_failures as p_fail
from primekg_rgcn_tpu_torch.analyze import case_studies as p_case
from primekg_rgcn_tpu_torch.analyze import compare_methods as p_cmp
from primekg_rgcn_tpu_torch.analyze import core as p_core
from primekg_rgcn_tpu_torch.analyze import error_analysis as p_err
from primekg_rgcn_tpu_torch.analyze import explain_predictions as p_expl
from primekg_rgcn_tpu_torch.analyze import medical_validation as p_val
from primekg_rgcn_tpu_torch.analyze import run_full_analysis as p_run
from primekg_rgcn_tpu_torch.analyze import visualize_embeddings as p_viz
from primekg_rgcn_tpu_torch.analyze.core import AnalysisContext, PathIndex
from port_analysis_data import build_trained, one_thread

TOL = 1e-9
PORT_TOOLS = (p_case, p_cmp, p_err, p_expl, p_fail, p_viz)
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return build_trained(tmp_path_factory.mktemp("port_analyze"))


@pytest.fixture(scope="module")
def jctx(trained):
    return JContext(*trained)


@pytest.fixture(scope="module")
def pctx(trained, jctx):
    """The port's context over the JAX context's embeddings."""
    return AnalysisContext(*trained, device="cpu", embeddings=jctx.embeddings)


@pytest.fixture
def no_port_plots(monkeypatch):
    """The port's tools as where matplotlib is not installed (their PNGs
    are not compared, and drawing them costs seconds)."""
    for mod in PORT_TOOLS:
        monkeypatch.setattr(mod, "pyplot", lambda *a, **k: None)


def _close(a, b, tol, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _close(a[k], b[k], tol, f"{where}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= tol, f"{where}: {a} vs {b}"
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


def _text_close(a: str, b: str, tol, where):
    """Equal text, but for numbers, which are within ``tol``."""
    assert NUMBER.sub("#", a) == NUMBER.sub("#", b), where
    for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
        assert abs(float(x) - float(y)) <= tol, f"{where}: {x} vs {y}"


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def compare_outputs(jdir, pdir, tol=TOL, tols=None):
    """Every .json/.csv/.txt/.md/.tex the JAX tool wrote under ``jdir`` is
    there under ``pdir`` and equal within ``tol`` (``tols``: per file
    name); the port wrote no such file the JAX tool did not."""
    kinds = {".json", ".csv", ".txt", ".md", ".tex"}
    want = sorted(p.relative_to(jdir) for p in Path(jdir).rglob("*")
                  if p.suffix in kinds)
    got = sorted(p.relative_to(pdir) for p in Path(pdir).rglob("*")
                 if p.suffix in kinds)
    assert got == want and want
    for rel in want:
        t = (tols or {}).get(rel.name, tol)
        a, b = Path(jdir) / rel, Path(pdir) / rel
        if rel.suffix == ".json":
            _close(json.loads(a.read_text()), json.loads(b.read_text()), t,
                   str(rel))
        elif rel.suffix == ".csv":
            ra, rb = _csv_rows(a), _csv_rows(b)
            assert len(ra) == len(rb), rel
            for x, y in zip(ra, rb):
                assert len(x) == len(y), rel
                for u, v in zip(x, y):
                    _text_close(u, v, t, str(rel))
        else:
            _text_close(a.read_text(), b.read_text(), t, str(rel))
    return want


def test_context_embeddings_match_jax(trained, jctx):
    ctx = AnalysisContext(*trained, device="cpu")
    np.testing.assert_allclose(ctx.embeddings, jctx.embeddings, rtol=2e-4,
                               atol=2e-5)
    assert ctx.embeddings.shape == (jctx.full_graph.num_nodes, 8)
    np.testing.assert_allclose(ctx.embeddings_norm, jctx.embeddings_norm,
                               rtol=2e-4, atol=2e-5)


def test_context_views_match_jax(pctx, jctx):
    assert pctx.node_names == jctx.node_names
    assert list(pctx.node_types) == list(jctx.node_types)
    for name in ("drug_indices", "disease_indices", "gene_indices"):
        np.testing.assert_array_equal(getattr(pctx, name),
                                      getattr(jctx, name))
    for query, kind in (("disease name 3", "disease"), ("DRUGNAME1", "drug"),
                        ("name 1", "disease"), ("nothing", "drug")):
        assert pctx.find_node(query, kind) == jctx.find_node(query, kind)
    d = int(jctx.disease_indices[0])
    assert pctx.top_drugs_for_disease(d, 5) == jctx.top_drugs_for_disease(d, 5)
    assert pctx.pair_relation == jctx.pair_relation
    # Same sets, iterated in the same order (the tools take prefixes).
    assert list(pctx.neighbor_sets) == sorted(jctx.neighbor_sets)
    for u, nb in jctx.neighbor_sets.items():
        assert list(pctx.neighbor_sets[u]) == list(nb)
        assert list(pctx.gene_neighbors(u)) == list(jctx.gene_neighbors(u))
    indptr, nbrs = pctx.path_index.adjacency
    for u in jctx.nx_graph.nodes:
        assert nbrs[indptr[u]:indptr[u + 1]].tolist() == list(
            jctx.nx_graph[u])
    for a, b in zip(jctx.full_edges[:50, 0], jctx.full_edges[:50, 1]):
        assert pctx.edge_relation_name(a, b) == jctx.edge_relation_name(a, b)


@pytest.mark.parametrize("max_length", [2, 3, 4])
def test_find_paths_on_the_fixture_graph_match_networkx(pctx, jctx,
                                                        max_length):
    pairs = [(int(a), int(b)) for a in jctx.drug_indices
             for b in jctx.disease_indices]
    pairs += [(int(jctx.gene_indices[0]), int(jctx.gene_indices[5])),
              (int(jctx.drug_indices[0]), int(jctx.drug_indices[0])), (0, -1)]
    for max_paths in (1, 3, 20):
        for a, b in pairs:
            assert pctx.find_paths(a, b, max_length, max_paths) == \
                jctx.find_paths(a, b, max_length, max_paths), (a, b)


def _nx_find_paths(g, source, target, max_length, max_paths):
    """The JAX context's ``find_paths`` on its networkx graph ``g``, and
    whether the pair has more than ``max_paths * 5`` paths (the search is
    cut)."""
    paths = list(itertools.islice(
        nx.all_simple_paths(g, source, target, cutoff=max_length),
        max_paths * 5 + 1))
    cut = len(paths) > max_paths * 5
    paths = paths[:max_paths * 5]
    paths.sort(key=len)
    return paths[:max_paths], cut


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_paths_on_random_hub_graphs_match_networkx(seed):
    """A random graph with two hubs of degree >= 50, duplicate and reversed
    edges, self-loops and an isolated component: pairs with no path, and
    pairs through the hubs with more than max_paths * 5 paths."""
    rng = np.random.default_rng(seed)
    n = 120
    edges = [rng.integers(0, 100, size=(150, 2))]
    for hub in (0, 1):
        others = rng.choice(np.arange(2, 100), 60, replace=False)
        edges.append(np.stack([np.full(60, hub), others], 1))
    edges.append(np.array([[5, 5], [7, 3], [3, 7], [100, 101], [101, 102]]))
    edges = np.concatenate(edges)
    edges = edges[rng.permutation(len(edges))]
    index = PathIndex(edges, n)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(map(tuple, edges[:, :2]))
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, 100, (12, 2))]
    pairs += [(0, 1), (2, 1), (100, 102), (3, 110), (110, 111), (4, 100)]
    cut = empty = 0
    for max_length in (2, 3, 4):
        for max_paths in (1, 4, 20):
            for a, b in pairs:
                want, was_cut = _nx_find_paths(g, a, b, max_length,
                                               max_paths)
                assert index.find_paths(a, b, max_length, max_paths) == want
                cut += was_cut and max_paths == 20
                empty += not want
    assert cut > 0 and empty > 0


def test_error_analysis_matches_jax(trained, jctx, pctx, tmp_path,
                                    no_port_plots):
    test = jart.split_to_edges(
        jart.load_dataset(trained[1], require_train=False)["test"])
    want = j_err.ErrorAnalyzer(jctx, test, tmp_path / "jax").run()
    got = p_err.ErrorAnalyzer(pctx, test, tmp_path / "port").run()
    _close(json.loads(json.dumps(got)), json.loads(json.dumps(want)), TOL,
           "run")
    files = compare_outputs(tmp_path / "jax", tmp_path / "port")
    assert {f.name for f in files} >= {"false_negatives.csv",
                                       "low_confidence.csv",
                                       "error_analysis_report.txt"}


def test_tools_draw_their_pngs_where_matplotlib_is_installed(
        trained, jctx, pctx, tmp_path):
    """The port's PNGs under the JAX tools' names, networkx pictures
    included, where matplotlib and networkx are installed."""
    test = jart.split_to_edges(
        jart.load_dataset(trained[1], require_train=False)["test"])
    p_err.ErrorAnalyzer(pctx, test, tmp_path / "err").run()
    p_case.DrugDiseaseCaseStudy(pctx, tmp_path / "case").run_case_study(
        "disease name 2", top_k=5)
    p_expl.PredictionExplainer(pctx, tmp_path / "expl").explain(
        "drugname1", "disease name 1")
    fail = p_fail.FailureAnalyzer(pctx, tmp_path / "fail").run(
        num_failures=3, num_successes=3, num_samples=200,
        visualize_subgraphs=True)
    want = {"err/error_patterns.png", "err/score_distribution.png",
            "err/entity_analysis.png", "case/disease_name_2/predictions.png"}
    got = {str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*.png")
           if p.stat().st_size > 0}
    assert want <= got
    j_case.DrugDiseaseCaseStudy(jctx, tmp_path / "jcase").run_case_study(
        "disease name 2", top_k=5)
    j_expl.PredictionExplainer(jctx, tmp_path / "jexpl").explain(
        "drugname1", "disease name 1")
    for tool in ("case", "expl"):
        assert sorted(p.relative_to(tmp_path / tool) for p in
                      (tmp_path / tool).rglob("*.png")) == sorted(
            p.relative_to(tmp_path / f"j{tool}") for p in
            (tmp_path / f"j{tool}").rglob("*.png"))
    n_sub = sum(len(fail["buckets"][k][:2])
                for k in ("false_positives", "false_negatives"))
    assert len(list((tmp_path / "fail").glob("subgraph_*.png"))) == n_sub


def test_case_studies_match_jax(jctx, pctx, tmp_path, no_port_plots):
    for disease in ("disease name 2", "disease name 5", "no such disease"):
        want = j_case.DrugDiseaseCaseStudy(
            jctx, tmp_path / "jax").run_case_study(disease, top_k=6)
        got = p_case.DrugDiseaseCaseStudy(
            pctx, tmp_path / "port").run_case_study(disease, top_k=6)
        _close(got, want, TOL, disease)
    compare_outputs(tmp_path / "jax", tmp_path / "port")


def test_explanations_match_jax(jctx, pctx, tmp_path, no_port_plots):
    for drug, disease in (("drugname1", "disease name 1"),
                          ("drugname7", "disease name 4"),
                          ("no such drug", "disease name 4")):
        want = j_expl.PredictionExplainer(jctx, tmp_path / "jax").explain(
            drug, disease, top_k=5)
        got = p_expl.PredictionExplainer(pctx, tmp_path / "port").explain(
            drug, disease, top_k=5)
        _close(got, want, TOL, drug)
    compare_outputs(tmp_path / "jax", tmp_path / "port")


def test_medical_validation_matches_jax(jctx, pctx, tmp_path):
    kw = dict(top_k=10, threshold=0.0, sample_diseases=4)
    want = j_val.MedicalValidator(jctx, tmp_path / "jax").run(**kw)
    got = p_val.MedicalValidator(pctx, tmp_path / "port").run(**kw)
    assert got
    _close(got, want, TOL, "run")
    compare_outputs(tmp_path / "jax", tmp_path / "port")


def test_method_comparison_matches_jax(jctx, pctx, tmp_path, no_port_plots):
    methods = ["random", "degree", "transe", "rgcn"]
    kw = dict(num_samples=300, frequency_analysis=True,
              statistical_tests=True)
    want = j_cmp.MethodComparator(jctx, tmp_path / "jax", methods,
                                  transe_epochs=2).run(**kw)
    got = p_cmp.MethodComparator(pctx, tmp_path / "port", methods,
                                 transe_epochs=2).run(**kw)
    assert set(got) == {"Random", "NodeDegree", "TransE", "RGCN"}
    for name, m in want.items():
        for k, v in m.items():
            assert abs(got[name][k] - v) <= (1e-7 if k == "auc_roc"
                                             else TOL), (name, k)
    # AUC-ROC and the mock p-values that follow from its gaps are float32
    # on the JAX side; the report and tables print them to 4 places.
    compare_outputs(tmp_path / "jax", tmp_path / "port",
                    tols={"test_results.csv": 1e-7})


def test_failure_analysis_matches_jax(jctx, pctx, tmp_path, no_port_plots):
    kw = dict(num_failures=3, num_successes=3, num_samples=200,
              visualize_subgraphs=True)
    want = j_fail.FailureAnalyzer(jctx, tmp_path / "jax").run(**kw)
    got = p_fail.FailureAnalyzer(pctx, tmp_path / "port").run(**kw)
    _close(got, want, TOL, "run")
    compare_outputs(tmp_path / "jax", tmp_path / "port")


def test_embedding_visualizer_matches_jax_where_it_draws_no_random(
        jctx, pctx, tmp_path, no_port_plots):
    """Nearest neighbours, the distance heatmaps' data and the statistics
    report equal the JAX tool's; the projection and the clustering run
    (their t-SNE and k-means are held against sklearn's in
    ``test_torch_port_embed_tools.py``)."""
    kw = dict(sample_size=40, query="drugname1", k_neighbors=4,
              skip_interactive=True)
    want = j_viz.EmbeddingVisualizer(jctx, tmp_path / "jax").run(**kw)
    viz = p_viz.EmbeddingVisualizer(pctx, tmp_path / "port")
    got = viz.run(**kw)
    _close(got, want, TOL, "run")
    compare_outputs(tmp_path / "jax", tmp_path / "port")
    heat = viz.distance_heatmaps()
    rng = np.random.default_rng(0)
    for t in ("drug", "disease", "gene/protein"):
        idx = jctx.indices_of_type(t)
        if len(idx) > 40:
            idx = rng.choice(idx, 40, replace=False)
        e = jctx.embeddings_norm[idx]
        np.testing.assert_array_equal(heat[t], 1.0 - e @ e.T)
    clusters = viz.cluster(n_clusters=3)
    assert set(clusters) == {"drug", "disease", "gene/protein"}
    for info in clusters.values():
        assert -1.0 <= info["silhouette"] <= 1.0
        assert sum(info["cluster_sizes"]) > 0
    assert (tmp_path / "port" / "clustering_summary.txt").exists()


ALL = list(p_run.ANALYSES)


def _summary(path):
    return [ln.split("\t")[:2] for ln in path.read_text().splitlines()]


def test_orchestrator_in_process_runs_all_eight(trained, tmp_path,
                                                no_port_plots):
    model, data = trained
    kw = dict(diseases=["disease name 1"],
              explanations=[("drugname2", "disease name 2")])
    want = j_run.AnalysisPipeline(model, tmp_path / "jax", data,
                                  **kw).run_all(only=ALL)
    got = p_run.AnalysisPipeline(model, tmp_path / "port", data,
                                 device="cpu", **kw).run_all(only=ALL)
    assert list(got) == ALL and all(r["success"] for r in got.values())
    assert [r["success"] for r in want.values()] == [True] * 8
    assert _summary(tmp_path / "port" / "analysis_summary.txt") == \
        _summary(tmp_path / "jax" / "analysis_summary.txt")
    assert (tmp_path / "port" / "results.json").exists()
    for name in ALL:
        log = tmp_path / "port" / f"{name}.log"
        assert log.exists() and log.stat().st_size > 0, name


def test_orchestrator_cli_subprocess_mode_on_the_cpu(trained, tmp_path):
    model, data = trained
    p_run.main(["--model_path", str(model), "--data_dir", str(data),
                "--output_dir", str(tmp_path), "--subprocess", "--device",
                "cpu", "--timeout", "240", "--analyses", "error_analysis",
                "case_studies", "--diseases", "disease name 1"])
    assert _summary(tmp_path / "analysis_summary.txt") == [
        ["error_analysis", "OK"], ["case_studies", "OK"]]
    assert (tmp_path / "error_analysis" /
            "error_analysis_report.txt").exists()
    assert (tmp_path / "case_studies" / "disease_name_1" /
            "predictions.json").exists()
    assert (tmp_path / "full_analysis.log").stat().st_size > 0


def test_orchestrator_isolates_an_analysis_that_raises(trained, tmp_path,
                                                       monkeypatch,
                                                       no_port_plots):
    def broken(self):
        raise RuntimeError("made to fail")

    monkeypatch.setattr(p_run.AnalysisPipeline, "_run_comparison", broken)
    model, data = trained
    got = p_run.AnalysisPipeline(model, tmp_path, data, device="cpu",
                                 diseases=["disease name 1"]).run_all(
        only=["error_analysis", "comparison", "failures"])
    assert {k: r["success"] for k, r in got.items()} == {
        "error_analysis": True, "comparison": False, "failures": True}
    assert "made to fail" in (tmp_path / "comparison.log").read_text()
    assert _summary(tmp_path / "analysis_summary.txt")[1] == ["comparison",
                                                              "FAILED"]


def test_context_refuses_cuda_without_a_card(trained, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        AnalysisContext(*trained)


def test_write_csv_writes_what_pandas_writes(tmp_path):
    pd = pytest.importorskip("pandas")
    scores = np.array([0.51234567, 0.1, 1 / 3], np.float32)
    cols = {"head_idx": np.array([1, 2, 3]), "name": ["x", "y,z", 'w"q'],
            "score": scores, "value": [0.5, 1.0, 1e-9]}
    pd.DataFrame(cols).to_csv(tmp_path / "want.csv", index=False)
    p_core.write_csv(tmp_path / "got.csv", list(cols), zip(*cols.values()))
    assert (tmp_path / "got.csv").read_text() == \
        (tmp_path / "want.csv").read_text()
    pd.DataFrame([]).to_csv(tmp_path / "want_empty.csv", index=False)
    p_core.write_csv(tmp_path / "got_empty.csv", [], [])
    assert (tmp_path / "got_empty.csv").read_text() == \
        (tmp_path / "want_empty.csv").read_text()
