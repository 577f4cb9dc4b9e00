"""The streamed Riccati pair, ``csrc/riccati_streamed.cu``: the backward
kernel (the compile-time instance of ``csrc/riccati_backward_fixed.cuh``
or the run-time ``riccati_backward_kernel``) and the forward kernel (the
instance of ``csrc/riccati_forward_fixed.cuh`` or the run-time
``riccati_forward_kernel``); one sweep is one backward and one forward
launch, counted by ``riccati_kernel.BACKWARD_LAUNCHES``."""

METRICS = ("kkt_sweep_roofline",)
PATTERNS = (r"riccati_general_backward_fixed<\s*\d+,\s*\d+,\s*1,\s*0\s*>",
            r"riccati_general_forward_fixed<\s*\d+,\s*\d+,\s*1,\s*0,",
            r"\briccati_backward_kernel\b",
            r"\briccati_forward_kernel\b")
SWEEP_COUNTERS = ("riccati_kernel.BACKWARD_LAUNCHES",)
