"""Full analysis orchestrator.

The counterpart of ``primekg_rgcn_tpu/analyze/run_full_analysis.py`` (the
reference's AnalysisPipeline, src/run_full_analysis.py): the same registry
of eight analyses (run_full_analysis.py:57-111), per-analysis failure
isolation, timing and a success/fail summary (227-359) — but runs them
**in-process** against ONE shared AnalysisContext instead of spawning a
subprocess per analysis that cold-starts python, reloads the checkpoint and
re-encodes the graph each time. A ``--subprocess`` flag restores the
reference's process-isolation behavior when wanted. Case studies loop over
diseases and explanations over (drug, disease) pairs exactly like the
reference special-cases (run_full_analysis.py:186-210). ``--device``
(default cuda, which raises without a card) goes to the context, to every
tool's ``main`` and to the evaluation CLI.

    python -m primekg_rgcn_tpu_torch.analyze.run_full_analysis \
        --model_path model.pt --data_dir data/processed \
        --output_dir results [--device cuda|cpu] [--subprocess]
"""

from __future__ import annotations

import argparse
import logging
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

DEFAULT_DISEASES = ["diabetes mellitus", "Alzheimer disease"]
DEFAULT_EXPLANATIONS = [("Metformin", "diabetes mellitus"),
                        ("Aspirin", "heart disease")]

ANALYSES = {
    "evaluate": "Model evaluation with metrics",
    "error_analysis": "Error pattern analysis",
    "case_studies": "Disease-specific case studies",
    "embeddings": "Embedding visualization",
    "explanations": "Path-based prediction explanations",
    "validation": "Medical validation of predictions",
    "comparison": "Method comparison with baselines",
    "failures": "Failure mode analysis",
}


class AnalysisPipeline:
    def __init__(self, model_path, output_dir="results",
                 data_dir="data/processed", *,
                 use_subprocess: bool = False, timeout: int = 300,
                 diseases: Optional[List[str]] = None,
                 explanations: Optional[List] = None, device: str = "cuda"):
        self.model_path = str(model_path)
        self.device = device
        self.output_dir = Path(output_dir)
        self.data_dir = str(data_dir)
        self.use_subprocess = use_subprocess
        self.timeout = timeout
        self.diseases = diseases or DEFAULT_DISEASES
        self.explanations = explanations or DEFAULT_EXPLANATIONS
        self.results: Dict[str, Dict] = {}
        self._ctx = None

    @property
    def ctx(self):
        if self._ctx is None:
            from primekg_rgcn_tpu_torch.analyze.core import AnalysisContext

            self._ctx = AnalysisContext(self.model_path, self.data_dir,
                                        device=self.device)
        return self._ctx

    # -- in-process runners --------------------------------------------------
    def _run_evaluate(self):
        from primekg_rgcn_tpu_torch.evaluate.cli import main as eval_main

        eval_main(["--model_path", self.model_path,
                   "--data_dir", self.data_dir,
                   "--output_dir", str(self.output_dir),
                   "--device", self.device])

    def _run_error_analysis(self):
        from primekg_rgcn_tpu_torch.data import artifacts
        from primekg_rgcn_tpu_torch.analyze.error_analysis import ErrorAnalyzer

        ds = artifacts.load_dataset(self.data_dir, require_train=False)
        if ds["test"] is None:
            raise FileNotFoundError("no test split")
        ErrorAnalyzer(self.ctx, artifacts.split_to_edges(ds["test"]),
                      self.output_dir / "error_analysis").run()

    def _run_case_studies(self):
        from primekg_rgcn_tpu_torch.analyze.case_studies import (
            DrugDiseaseCaseStudy,
        )

        study = DrugDiseaseCaseStudy(self.ctx,
                                     self.output_dir / "case_studies")
        for disease in self.diseases:
            if study.run_case_study(disease) is None:
                logger.warning("Case study skipped (disease not found): %s",
                               disease)

    def _run_embeddings(self):
        from primekg_rgcn_tpu_torch.analyze.visualize_embeddings import (
            EmbeddingVisualizer,
        )

        EmbeddingVisualizer(self.ctx, self.output_dir / "embeddings").run(
            sample_size=5000, skip_interactive=True)

    def _run_explanations(self):
        from primekg_rgcn_tpu_torch.analyze.explain_predictions import (
            PredictionExplainer,
        )

        ex = PredictionExplainer(self.ctx, self.output_dir / "explanations")
        for drug, disease in self.explanations:
            if ex.explain(drug, disease, top_k=5) is None:
                logger.warning("Explanation skipped (pair not found): "
                               "%s -> %s", drug, disease)

    def _run_validation(self):
        from primekg_rgcn_tpu_torch.analyze.medical_validation import (
            MedicalValidator,
        )

        MedicalValidator(self.ctx, self.output_dir / "validation").run(
            top_k=50, sample_diseases=100)

    def _run_comparison(self):
        from primekg_rgcn_tpu_torch.analyze.compare_methods import (
            MethodComparator,
        )

        MethodComparator(self.ctx, self.output_dir / "comparison",
                         ["random", "degree", "rgcn"]).run(
            frequency_analysis=True)

    def _run_failures(self):
        from primekg_rgcn_tpu_torch.analyze.analyze_failures import (
            FailureAnalyzer,
        )

        FailureAnalyzer(self.ctx, self.output_dir / "failure_analysis").run(
            num_failures=5, num_successes=5, visualize_subgraphs=True)

    # -- subprocess mode -----------------------------------------------------
    _MODULES = {
        "evaluate": "primekg_rgcn_tpu_torch.evaluate.cli",
        "error_analysis": "primekg_rgcn_tpu_torch.analyze.error_analysis",
        "embeddings": "primekg_rgcn_tpu_torch.analyze.visualize_embeddings",
        "validation": "primekg_rgcn_tpu_torch.analyze.medical_validation",
        "comparison": "primekg_rgcn_tpu_torch.analyze.compare_methods",
        "failures": "primekg_rgcn_tpu_torch.analyze.analyze_failures",
    }

    def _run_subprocess(self, name: str) -> bool:
        """Process-isolated execution (the reference's only mode,
        run_full_analysis.py:241-249)."""
        def run(extra):
            cmd = [sys.executable, "-m", self._MODULES.get(
                name, "primekg_rgcn_tpu_torch.analyze." + name),
                "--model_path", self.model_path,
                "--data_dir", self.data_dir, "--device", self.device] + extra
            r = subprocess.run(cmd, timeout=self.timeout,
                               capture_output=True, text=True)
            if r.returncode != 0:
                logger.error("%s failed:\n%s", name, r.stderr[-2000:])
            return r.returncode == 0

        sub = {"evaluate": "", "error_analysis": "error_analysis",
               "embeddings": "embeddings", "validation": "validation",
               "comparison": "comparison", "failures": "failure_analysis"}
        if name == "case_studies":
            ok = True
            for d in self.diseases:
                ok &= subprocess.run(
                    [sys.executable, "-m",
                     "primekg_rgcn_tpu_torch.analyze.case_studies",
                     "--model_path", self.model_path,
                     "--data_dir", self.data_dir, "--device", self.device,
                     "--output_dir", str(self.output_dir / "case_studies"),
                     "--disease", d],
                    timeout=self.timeout).returncode == 0
            return ok
        if name == "explanations":
            ok = True
            for drug, disease in self.explanations:
                ok &= subprocess.run(
                    [sys.executable, "-m",
                     "primekg_rgcn_tpu_torch.analyze.explain_predictions",
                     "--model_path", self.model_path,
                     "--data_dir", self.data_dir, "--device", self.device,
                     "--output_dir", str(self.output_dir / "explanations"),
                     "--drug", drug, "--disease", disease],
                    timeout=self.timeout).returncode == 0
            return ok
        out = self.output_dir / sub[name] if sub[name] else self.output_dir
        return run(["--output_dir", str(out)])

    # -- orchestration -------------------------------------------------------
    def run_analysis(self, name: str) -> bool:
        if name not in ANALYSES:
            raise ValueError(f"unknown analysis: {name}")
        # Dedicated per-analysis log file, like the reference's per-script
        # logs (reference: src/evaluate.py:855-860 -> results/evaluation.log,
        # src/error_analysis.py etc.): everything the analysis logs while it
        # runs also lands in <output_dir>/<name>.log. The root level is
        # lowered to INFO for the duration so the file captures the
        # analyses' INFO records even under a WARNING-level host config.
        self.output_dir.mkdir(parents=True, exist_ok=True)
        handler = logging.FileHandler(self.output_dir / f"{name}.log")
        handler.setFormatter(logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        root = logging.getLogger()
        old_level = root.level
        root.addHandler(handler)
        if old_level > logging.INFO or old_level == logging.NOTSET:
            root.setLevel(logging.INFO)
        logger.info("=" * 60)
        logger.info("Running %s: %s", name, ANALYSES[name])
        t0 = time.time()
        try:
            if self.use_subprocess:
                ok = self._run_subprocess(name)
            else:
                getattr(self, f"_run_{name}")()
                ok = True
        except Exception as e:  # isolation: one failure never kills the run
            logger.exception("%s failed: %s", name, e)
            ok = False
        finally:
            root.removeHandler(handler)
            handler.close()
            root.setLevel(old_level)
        dt = time.time() - t0
        self.results[name] = {"success": ok, "duration_s": round(dt, 2)}
        logger.info("%s %s in %.1fs", name, "OK" if ok else "FAILED", dt)
        return ok

    def run_all(self, only: Optional[List[str]] = None,
                skip: Optional[List[str]] = None) -> Dict[str, Dict]:
        names = [n for n in (only or list(ANALYSES))
                 if n not in set(skip or [])]
        t0 = time.time()
        for n in names:
            self.run_analysis(n)
        total = time.time() - t0

        n_ok = sum(1 for r in self.results.values() if r["success"])
        logger.info("=" * 60)
        logger.info("ANALYSIS SUMMARY: %d/%d succeeded in %.1fs",
                    n_ok, len(self.results), total)
        for n, r in self.results.items():
            logger.info("  %-16s %-7s %.1fs", n,
                        "OK" if r["success"] else "FAILED", r["duration_s"])
        summary = self.output_dir / "analysis_summary.txt"
        summary.parent.mkdir(parents=True, exist_ok=True)
        summary.write_text("\n".join(
            f"{n}\t{'OK' if r['success'] else 'FAILED'}\t{r['duration_s']}s"
            for n, r in self.results.items()))
        return self.results


def main(argv=None):
    p = argparse.ArgumentParser(description="Run the full analysis suite")
    p.add_argument("--model_path", default="output/models/best_model.pt")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--analyses", nargs="+", default=None,
                   help="subset of analyses to run")
    p.add_argument("--skip", nargs="+", default=None)
    p.add_argument("--timeout", type=int, default=300)
    p.add_argument("--subprocess", action="store_true",
                   help="run each analysis in an isolated subprocess "
                        "(the reference's behavior)")
    p.add_argument("--diseases", nargs="+", default=None,
                   help="disease names for the case-study loop (default: "
                        "the reference's diabetes/Alzheimer pair; "
                        "synthetically trained models need synthetic "
                        "names, e.g. 'synthetic disease 0')")
    p.add_argument("--explain", nargs=2, action="append", default=None,
                   metavar=("DRUG", "DISEASE"),
                   help="(drug, disease) pair for the explanation loop; "
                        "repeatable")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)

    if args.list:
        for n, d in ANALYSES.items():
            print(f"{n:16s} {d}")
        return None

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=[logging.StreamHandler(sys.stdout)])
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    file_log = logging.FileHandler(Path(args.output_dir) / "full_analysis.log")
    file_log.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    root = logging.getLogger()
    root.addHandler(file_log)

    pipe = AnalysisPipeline(args.model_path, args.output_dir, args.data_dir,
                            use_subprocess=args.subprocess,
                            timeout=args.timeout,
                            diseases=args.diseases,
                            explanations=[tuple(e) for e in args.explain]
                            if args.explain else None,
                            device=args.device)
    try:
        return pipe.run_all(args.analyses, args.skip)
    finally:
        root.removeHandler(file_log)
        file_log.close()


if __name__ == "__main__":
    main()
