"""Medical validation of novel predictions.

The counterpart of ``primekg_rgcn_tpu/analyze/medical_validation.py`` (the
reference's MedicalValidator, src/medical_validation.py): generate novel
drug-disease predictions per sampled disease (cosine score >= threshold,
known direct associations dropped, medical_validation.py:191-280), gather
evidence features — drug-target / disease-gene overlap (322-354), common
gene neighbors (356-394), similar known drugs (420-461), and the
reference's **mock** literature / clinical-trials searches (463-554;
keyword heuristics + seeded RNG, faithfully reproduced as mocks and labeled
as such) — then combine them with the reference's weights
(0.25/0.20/0.20/0.20/0.15, medical_validation.py:623-672) into a validation
score with confidence tiers, and write a report and a CSV (with ``csv``, as
pandas writes it).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from primekg_rgcn_tpu_torch.analyze.core import AnalysisContext, write_csv

logger = logging.getLogger(__name__)

EVIDENCE_WEIGHTS = {
    "target_overlap": 0.25,
    "common_neighbors": 0.20,
    "similar_drugs": 0.20,
    "literature": 0.20,
    "clinical_trials": 0.15,
}


class MedicalValidator:
    def __init__(self, ctx: AnalysisContext, output_dir):
        self.ctx = ctx
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    # -- prediction generation ----------------------------------------------
    def generate_novel_predictions(self, top_k: int = 50,
                                   threshold: float = 0.6,
                                   sample_diseases: Optional[int] = None,
                                   seed: int = 42) -> List[Dict]:
        ctx = self.ctx
        rng = np.random.default_rng(seed)
        diseases = ctx.disease_indices
        if sample_diseases is not None and sample_diseases < len(diseases):
            diseases = rng.choice(diseases, sample_diseases, replace=False)

        preds = []
        for d in diseases:
            scores = ctx.cosine_scores_against(int(d), ctx.drug_indices)
            keep = np.flatnonzero(scores >= threshold)
            if len(keep) == 0:
                continue
            known = ctx.known_direct_associations(
                int(d), ctx.drug_indices[keep].tolist())
            for i in keep:
                drug = int(ctx.drug_indices[i])
                if known.get(drug, False):
                    continue
                preds.append({"drug_idx": drug, "disease_idx": int(d),
                              "score": float(scores[i])})
        preds.sort(key=lambda p: -p["score"])
        return preds[:top_k]

    # -- evidence features ---------------------------------------------------
    def target_overlap(self, drug_idx: int, disease_idx: int) -> float:
        dt = self.ctx.gene_neighbors(drug_idx)
        dg = self.ctx.gene_neighbors(disease_idx)
        if not dt or not dg:
            return 0.0
        return len(dt & dg) / len(dt | dg)

    def common_neighbors(self, drug_idx: int, disease_idx: int) -> float:
        common = (self.ctx.gene_neighbors(drug_idx)
                  & self.ctx.gene_neighbors(disease_idx))
        return min(len(common) / 10.0, 1.0)

    def similar_drugs_evidence(self, drug_idx: int, disease_idx: int,
                               k: int = 20) -> float:
        """Share of the drug's k most cosine-similar drugs that touch the
        disease's gene set (reference: medical_validation.py:420-461)."""
        ctx = self.ctx
        sims = ctx.embeddings_norm[ctx.drug_indices] \
            @ ctx.embeddings_norm[drug_idx]
        order = np.argsort(-sims)
        disease_genes = ctx.gene_neighbors(disease_idx)
        if not disease_genes:
            return 0.0
        hits = total = 0
        for i in order[1:k + 1]:
            other = int(ctx.drug_indices[i])
            total += 1
            if ctx.gene_neighbors(other) & disease_genes:
                hits += 1
        return hits / max(total, 1)

    def mock_literature_search(self, drug: str, disease: str,
                               seed: int) -> Dict:
        """MOCK evidence source, reproduced from the reference
        (medical_validation.py:463-509): keyword heuristics + seeded RNG.
        Not a real literature API — a placeholder the reference also uses."""
        rng = np.random.default_rng(abs(hash((drug, disease, seed))) % 2**31)
        common_terms = ["cancer", "diabetes", "inflammation", "syndrome",
                        "deficiency"]
        base = 0.2 + 0.3 * any(t in disease.lower() for t in common_terms)
        n_papers = int(rng.poisson(3 * base + 0.5))
        return {"mock": True, "num_papers": n_papers,
                "score": min(n_papers / 10.0, 1.0)}

    def mock_clinical_trials_search(self, drug: str, disease: str,
                                    seed: int) -> Dict:
        """MOCK evidence source (reference: medical_validation.py:511-554)."""
        rng = np.random.default_rng(abs(hash((disease, drug, seed))) % 2**31)
        n_trials = int(rng.binomial(3, 0.2))
        phase = int(rng.integers(1, 4)) if n_trials else 0
        return {"mock": True, "num_trials": n_trials, "max_phase": phase,
                "score": min((n_trials + phase) / 6.0, 1.0)}

    # -- scoring -------------------------------------------------------------
    def validate_prediction(self, pred: Dict, seed: int = 42) -> Dict:
        ctx = self.ctx
        drug = ctx.node_names[pred["drug_idx"]]
        disease = ctx.node_names[pred["disease_idx"]]
        evidence = {
            "target_overlap": self.target_overlap(pred["drug_idx"],
                                                  pred["disease_idx"]),
            "common_neighbors": self.common_neighbors(pred["drug_idx"],
                                                      pred["disease_idx"]),
            "similar_drugs": self.similar_drugs_evidence(pred["drug_idx"],
                                                         pred["disease_idx"]),
            "literature": self.mock_literature_search(drug, disease,
                                                      seed)["score"],
            "clinical_trials": self.mock_clinical_trials_search(
                drug, disease, seed)["score"],
        }
        vscore = sum(EVIDENCE_WEIGHTS[k] * v for k, v in evidence.items())
        confidence = ("high" if vscore >= 0.5 else
                      "medium" if vscore >= 0.25 else "low")
        checklist = {k: v > 0 for k, v in evidence.items()}
        return {"drug": drug, "disease": disease,
                "prediction_score": pred["score"], "evidence": evidence,
                "validation_score": float(vscore), "confidence": confidence,
                "checklist": checklist}

    def run(self, top_k: int = 50, threshold: float = 0.6,
            sample_diseases: Optional[int] = None, seed: int = 42,
            output_csv: str = "validation_results.csv") -> List[Dict]:
        preds = self.generate_novel_predictions(top_k, threshold,
                                                sample_diseases, seed)
        logger.info("Validating %d novel predictions", len(preds))
        results = [self.validate_prediction(p, seed) for p in preds]

        rows = [{"drug": r["drug"], "disease": r["disease"],
                 "prediction_score": r["prediction_score"],
                 **{f"ev_{k}": v for k, v in r["evidence"].items()},
                 "validation_score": r["validation_score"],
                 "confidence": r["confidence"]} for r in results]
        write_csv(self.output_dir / output_csv, list(rows[0]) if rows else [],
                  [list(r.values()) for r in rows])

        lines = ["=" * 60, "MEDICAL VALIDATION REPORT", "=" * 60, "",
                 "NOTE: literature and clinical-trials evidence are MOCK",
                 "sources (as in the reference pipeline).", "",
                 f"Predictions validated: {len(results)}"]
        for tier in ["high", "medium", "low"]:
            sel = [r for r in results if r["confidence"] == tier]
            lines.append(f"\n{tier.upper()} confidence ({len(sel)}):")
            for r in sel[:15]:
                lines.append(f"  {r['drug'][:30]:32s} -> "
                             f"{r['disease'][:30]:32s} "
                             f"val={r['validation_score']:.3f} "
                             f"pred={r['prediction_score']:.3f}")
        (self.output_dir / "validation_report.txt").write_text(
            "\n".join(lines))
        logger.info("Saved validation results to %s", self.output_dir)
        return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Medically validate novel "
                                            "drug-disease predictions")
    p.add_argument("--model_path", default="output/models/best_model.pt")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--top_k", type=int, default=50)
    p.add_argument("--threshold", type=float, default=0.6)
    p.add_argument("--sample_diseases", type=int, default=None)
    p.add_argument("--output_dir", default="results/validation")
    p.add_argument("--output_csv", default="validation_results.csv")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    ctx = AnalysisContext(args.model_path, args.data_dir, device=args.device)
    return MedicalValidator(ctx, args.output_dir).run(
        args.top_k, args.threshold, args.sample_diseases, args.seed,
        args.output_csv)


if __name__ == "__main__":
    main()
