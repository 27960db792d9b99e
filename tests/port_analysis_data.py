"""Helpers of the analysis tests, in a module that is not a test file.

``build_trained``: a tiny kg.csv, preprocessed and trained on (2 epochs,
width 8) by the port's CLIs on the CPU; ``test_torch_port_analyze.py``
uses it, and so does the stand-alone check in
``test_torch_port_imports.py``, in a process where sklearn, networkx,
pandas and matplotlib cannot be imported.

``one_thread``: a context (each test module holds it open through an
autouse fixture) that gives torch one intra-op thread and caps the OpenMP and BLAS pools of numpy and sklearn at one
while the module's tests run. The suite runs six workers on the machine's
cores, and oversubscribed OpenMP pools stall the many small operations of
t-SNE and k-means: a t-SNE of 300 points took minutes instead of half a
second.
"""

import contextlib
import csv
import os

import numpy as np

ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                  "OPENBLAS_NUM_THREADS": "1"}


@contextlib.contextmanager
def one_thread():
    import torch
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    env = {k: os.environ.get(k) for k in ONE_THREAD_ENV}
    os.environ.update(ONE_THREAD_ENV)   # for subprocesses the tests start
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def write_tiny_kg(path):
    """The kg.csv of ``tests/test_analyze.py``: 15 drugs with 4 targets
    each, 120 random gene-gene rows, 8 diseases with 3 genes each."""
    rng = np.random.default_rng(1)
    n_drug, n_gene, n_dis = 15, 30, 8
    rows = []
    for d in range(n_drug):
        for g in rng.choice(n_gene, 4, replace=False):
            rows.append(("drug_protein", f"DB{d}", "drug", f"drugname{d}",
                         f"P{g}", "gene/protein", f"genename{g}"))
    for _ in range(120):
        a, b = rng.integers(n_gene), rng.integers(n_gene)
        rows.append(("protein_protein", f"P{a}", "gene/protein",
                     f"genename{a}", f"P{b}", "gene/protein", f"genename{b}"))
    for s in range(n_dis):
        for g in rng.choice(n_gene, 3, replace=False):
            rows.append(("disease_protein", f"D{s}", "disease",
                         f"disease name {s}", f"P{g}", "gene/protein",
                         f"genename{g}"))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["relation", "x_id", "x_type", "x_name", "y_id", "y_type",
                    "y_name"])
        w.writerows(rows)


def build_trained(tmp):
    """Preprocess the tiny kg.csv and train on it with the port's CLIs on
    the CPU; returns (best_model.pt, processed dir)."""
    from primekg_rgcn_tpu_torch.data.preprocess import main as preprocess
    from primekg_rgcn_tpu_torch.train.cli import main as train

    write_tiny_kg(tmp / "kg.csv")
    preprocess(["--raw-data", str(tmp / "kg.csv"), "--processed-dir",
                str(tmp / "processed"), "--no-torch"])
    train(["--data_dir", str(tmp / "processed"), "--output_dir",
           str(tmp / "output"), "--epochs", "2", "--batch_size", "256",
           "--embedding_dim", "8", "--hidden_dim", "8", "--device", "cpu"])
    return tmp / "output" / "models" / "best_model.pt", tmp / "processed"
