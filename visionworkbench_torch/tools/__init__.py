"""Measurement tools of the port, run on a CUDA card from the repository
root: ``mgm_scan_ablation`` (what each part of the register-carry SGM/MGM
kernel costs)."""
