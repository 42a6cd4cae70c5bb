"""Examples of the port, run as modules:

    python -m motcpp_tpu_torch.examples.basic_tracking [--cpu] [--tracker NAME] [--lap LAP]
    python -m motcpp_tpu_torch.examples.simple_tracking [--cpu] [--lap LAP]
    python -m motcpp_tpu_torch.examples.functional_core [--cpu] [--lap LAP]
    python -m motcpp_tpu_torch.examples.multistream_tpu [--cpu] [--streams 64] [--frames 30] [--lap LAP]
    python -m motcpp_tpu_torch.examples.multistream_serving [--cpu] [--lap LAP]
    python -m motcpp_tpu_torch.examples.stream_rebalance [--cpu] [--frames 12] [--move-at 6] [--lap LAP]
    python -m motcpp_tpu_torch.examples.moving_camera [--cpu] [--streams 4] [--ticks 8] [--lap LAP]
    python -m motcpp_tpu_torch.examples.async_serving [--cpu] [--streams 8] [--ticks 12] [--lap LAP]

Each is the counterpart of the JAX package's ``examples/<name>.py``, with
its flags, its printed lines and its exit codes, and has ``main(argv=None)
-> int``. Each runs on the CUDA device and raises without one unless given
``--cpu``. ``--lap`` picks the assignment solver of the tracker it builds:
``jv`` (the exact solver), ``auction`` (the plain auction) or
``auction_pallas`` (the auction CUDA kernel on the card, the plain auction
on the CPU). Importing an example runs nothing.
"""
