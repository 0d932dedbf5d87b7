"""Training diagnostics: the metrics log, objective quality numbers,
profiling, mel PNGs and the in-training synthesis probes."""

from spev_tpu_torch.diag.metrics import log_metrics
from spev_tpu_torch.diag.plots import save_comparison_plot, save_mel_plot
from spev_tpu_torch.diag.probes import mel_statistics, test_inference_probe
from spev_tpu_torch.diag.profiling import StepTimer, timed_steps, trace

__all__ = [
    "log_metrics",
    "save_mel_plot",
    "save_comparison_plot",
    "trace",
    "timed_steps",
    "StepTimer",
    "test_inference_probe",
    "mel_statistics",
]
