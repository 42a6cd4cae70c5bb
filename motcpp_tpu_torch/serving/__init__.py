"""Serving runtime: native stream multiplexer + continuous service loop.

Counterpart of ``motcpp_tpu/serving``, on one device: threads only queue
frames (the native C++ mux, ``native/motcpp_mux.cpp``), and the device
steps all streams at once as one stream-batched step, with per-stream
state selection giving exact per-stream semantics under irregular frame
arrival.
"""

from motcpp_tpu_torch.serving.mux import (  # noqa: F401
    PyStreamMux,
    StreamMux,
    create_mux,
    native_available,
)
from motcpp_tpu_torch.serving.service import (  # noqa: F401
    ServedBatch,
    StreamHandle,
    TrackingService,
    make_service_step,
)
