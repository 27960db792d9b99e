"""The port's numpy-only preprocessor against the JAX package's pandas one,
on kg.csv files that the tests write themselves (the raw PrimeKG file is
not in the repo): every artifact equal, and the split helper equal to
sklearn's ``train_test_split``."""

import csv
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.model_selection import train_test_split

from primekg_rgcn_tpu.data import preprocess as jpre
from primekg_rgcn_tpu_torch.config import DataConfig
from primekg_rgcn_tpu_torch.data import preprocess as ppre

HEADER = ["relation", "display_relation", "x_index", "x_id", "x_type",
          "x_name", "x_source", "y_index", "y_id", "y_type", "y_name",
          "y_source"]


def _write_kg(path, seed, *, with_drug_gene=True):
    """A small PrimeKG-shaped kg.csv: x_id mixes DrugBank and integer ids,
    y_id is all integers (some with leading zeros or a '+' sign, which
    pandas reads as integers), the three kept relations, rows of other
    types and relations to filter out, and duplicated rows."""
    rng = np.random.default_rng(seed)
    drugs = [(f"DB{i:05d}", f"drug {i}", "drug") for i in range(12)]
    genes = [(str(1000 + i), f"GENE{i}", "gene/protein") for i in range(30)]
    diseases = [(str(5000 + i), f"disease, {i}", "disease") for i in range(10)]
    anatomy = [(f"UBERON:{i}", f"organ {i}", "anatomy") for i in range(4)]
    # The same gene under a second name: two idx2node rows, one key.
    genes.append(("1003", "GENE3 alias", "gene/protein"))

    def y_text(node_id, k):
        return {0: node_id, 1: "00" + node_id, 2: "+" + node_id}[k % 3] \
            if node_id.isdigit() else node_id

    rows = []
    index = {}

    def add(rel, disp, x, y, k):
        for node in (x, y):
            index.setdefault(node[:1] + node[2:], len(index))
        rows.append([rel, disp, index[x[:1] + x[2:]], x[0], x[2], x[1],
                     "src", index[y[:1] + y[2:]], y_text(y[0], k), y[2],
                     y[1], "src"])

    pairs = []
    if with_drug_gene:
        pairs += [("drug_protein", "target", drugs, genes, 60)]
    pairs += [("protein_protein", "ppi", genes, genes, 90),
              ("disease_protein", "associated with", diseases, genes, 40),
              ("indication", "indication", drugs, diseases, 15),
              ("anatomy_protein_present", "expression present", anatomy,
               genes, 10)]
    for rel, disp, xs, ys, count in pairs:
        for k in range(count):
            add(rel, disp, xs[rng.integers(len(xs))], ys[rng.integers(len(ys))],
                k)
    rows += [rows[i] for i in rng.integers(0, len(rows), 8)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        w.writerows(rows)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_same_outputs(jdir, pdir, torch_files=True):
    for name in ("train_data", "val_data", "test_data", "full_graph"):
        with np.load(jdir / f"{name}.npz") as a, \
                np.load(pdir / f"{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=name + k)
        if torch_files:
            ja = torch.load(jdir / f"{name}.pt", weights_only=False)
            pa = torch.load(pdir / f"{name}.pt", weights_only=False)
            assert ja.keys() == pa.keys()
            for k in ja:
                if isinstance(ja[k], torch.Tensor):
                    assert torch.equal(ja[k], pa[k])
                else:
                    assert ja[k] == pa[k]
        assert (pdir / f"{name}.pt").exists() == torch_files
    assert (json.loads((jdir / "mappings.json").read_text())
            == json.loads((pdir / "mappings.json").read_text()))
    if torch_files:
        assert (torch.load(jdir / "mappings.pt", weights_only=False)
                == torch.load(pdir / "mappings.pt", weights_only=False))
    for name in ("train_edges.csv", "val_edges.csv", "test_edges.csv",
                 "statistics.csv"):
        assert _read_csv(jdir / name) == _read_csv(pdir / name), name


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("keep_all", [False, True])
def test_port_preprocessor_writes_the_jax_artifacts(tmp_path, seed, keep_all):
    raw = tmp_path / "kg.csv"
    _write_kg(raw, seed)
    jpre.PrimeKGPreprocessor(raw, tmp_path / "jax",
                             keep_all_relations=keep_all).process(
        random_seed=seed)
    pp = ppre.PrimeKGPreprocessor(raw, tmp_path / "port",
                                  keep_all_relations=keep_all)
    pp.process(random_seed=seed)
    _assert_same_outputs(tmp_path / "jax", tmp_path / "port")
    # The two-name gene: two idx2node rows, one node2idx key.
    assert len(pp.idx2node) == len(pp.node2idx) + 1
    stats = dict(zip(*_read_csv(tmp_path / "port" / "statistics.csv")))
    assert int(stats["filtered_edges"]) > int(stats["train_target_edges"])


def test_gene_disease_fallback_and_no_torch_cli(tmp_path):
    raw = tmp_path / "kg.csv"
    _write_kg(raw, 3, with_drug_gene=False)
    argv = ["--raw-data", str(raw), "--seed", "5", "--no-torch"]
    jpre.main([*argv, "--processed-dir", str(tmp_path / "jax")])
    ppre.main([*argv, "--processed-dir", str(tmp_path / "port")])
    _assert_same_outputs(tmp_path / "jax", tmp_path / "port",
                         torch_files=False)
    rels = json.loads((tmp_path / "port" / "mappings.json").read_text())
    assert "drug-gene" not in rels["relation2idx"]
    test_rel = np.load(tmp_path / "port" / "test_data.npz")["edge_type"]
    assert set(test_rel) == {rels["relation2idx"]["gene-disease"]}


def test_main_refuses_ratios_that_do_not_sum_to_one(tmp_path):
    with pytest.raises(ValueError, match="sum to 1.0"):
        ppre.main(["--raw-data", str(tmp_path / "kg.csv"), "--processed-dir",
                   str(tmp_path / "out"), "--train-ratio", "0.8"])


def test_integer_columns_are_read_as_pandas_reads_them(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b,c\n007,x1,1.50\n+3,2,\n-0, 4 ,2\n")
    t = ppre.Table.read_csv(path)
    assert list(t["a"]) == ["7", "3", "0"]
    assert list(t["b"]) == ["x1", "2", " 4 "]
    # Floats and empty cells keep their text (pandas: 1.5, NaN, 2.0).
    assert list(t["c"]) == ["1.50", "", "2"]


def test_data_config_matches_the_jax_one():
    from primekg_rgcn_tpu.config import DataConfig as JDataConfig

    assert DataConfig().to_dict() == JDataConfig().to_dict()


@settings(max_examples=60, deadline=None)
@given(n=st.integers(2, 400), seed=st.integers(0, 2 ** 31 - 1),
       test_size=st.sampled_from([0.15, 0.3, 0.5, 0.2, 0.7]))
def test_split_indices_equal_sklearn(n, seed, test_size):
    rows = np.arange(n)
    if n - int(np.ceil(test_size * n)) == 0:
        with pytest.raises(ValueError):
            train_test_split(rows, test_size=test_size, random_state=seed)
        with pytest.raises(ValueError):
            ppre.train_test_indices(n, test_size, seed)
        return
    want_train, want_test = train_test_split(rows, test_size=test_size,
                                             random_state=seed)
    got_train, got_test = ppre.train_test_indices(n, test_size, seed)
    np.testing.assert_array_equal(got_train, want_train)
    np.testing.assert_array_equal(got_test, want_test)


@pytest.mark.parametrize("n", [7, 100, 1001])
def test_split_indices_at_the_checked_sizes(n):
    rows = np.arange(n)
    for test_size in (0.3, 0.5):
        want = train_test_split(rows, test_size=test_size, random_state=42)
        got = ppre.train_test_indices(n, test_size, 42)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
