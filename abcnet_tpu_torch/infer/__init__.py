from .assemble import assemble_batch, assemble_smiles
from .decode import DecodeConfig, extract_peaks, make_infer_pipeline

__all__ = ["extract_peaks", "DecodeConfig", "make_infer_pipeline",
           "assemble_smiles", "assemble_batch"]
