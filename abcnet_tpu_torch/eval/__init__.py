from .scoring import ScoreReport, score_pairs, write_results_csv

__all__ = ["ScoreReport", "score_pairs", "write_results_csv"]
