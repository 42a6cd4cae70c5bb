"""Counterparts of motcpp_tpu.ops: box, cost, Kalman and assignment ops
on tensors with leading batch dimensions."""
