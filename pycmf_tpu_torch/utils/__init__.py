"""Host-side utilities of the PyTorch port: validation, init, analysis,
checkpoints, profiling, datasets, conversion of fitted factors."""
from .analysis import top_terms_per_component, topic_terms_string
from .checkpoint import (load_checkpoint, load_model, save_checkpoint,
                         save_model)
from .init import initialize_factors
from .profiling import StepTimer, annotate, trace

__all__ = [
    "top_terms_per_component", "topic_terms_string", "load_checkpoint",
    "load_model", "save_checkpoint", "save_model", "initialize_factors",
    "StepTimer", "annotate", "trace",
]
