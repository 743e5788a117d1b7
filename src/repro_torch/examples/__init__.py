"""Runnable examples of the port, each a counterpart of the reference
package's script of the same name under examples/:

    python -m repro_torch.examples.fleet_experiment [--device cpu]
    python -m repro_torch.examples.adaptive_serving [--device cpu]
    python -m repro_torch.examples.continual_distillation [--device cpu]
    python -m repro_torch.examples.quickstart

They run on the CUDA card unless `--device cpu` is given (the
quickstart is host numpy only and takes no device), take the same
REPRO_EX_* environment overrides and print the same result lines.
"""
