"""hisat2_tpu_torch.parallel: several devices and several hosts
(counterpart of hisat2_tpu/parallel: mesh.py, multihost.py), and the
dry-run twin of __graft_entry__.py:dryrun_multichip (dryrun.py)."""
