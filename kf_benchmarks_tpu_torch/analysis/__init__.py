"""Analysis of the port's programs: the fingerprints the compile ledger and
the run store key on (baseline.py), the step's program contract traced on
fake tensors in a fake process group (contracts.py) and its goldens, the
rules that bind it (audit.py), the ordered schedules (spmd.py) and the
autotuner behind --autotuned_config (autotune.py);
``python -m kf_benchmarks_tpu_torch.analysis`` runs them."""
