"""Measurement tools of the port, run as modules:

    python -m motcpp_tpu_torch.scripts.serving_latency [--cpu] ...
    python -m motcpp_tpu_torch.scripts.slo_sweep [--cpu] ...

Importing a tool runs nothing; each defaults to the CUDA device and
raises without one unless given ``--cpu``.
"""
