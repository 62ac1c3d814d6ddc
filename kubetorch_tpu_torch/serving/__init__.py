"""The seams between a torch rank and the fabric that launched it, the
counterparts of ``kubetorch_tpu/serving``'s device-facing helpers:

- ``distributed_env``: the rank's identity from the injected env, and
  ``torch.distributed`` brought up from it (``distributed.
  init_process_group``, nccl on the card, gloo on the CPU);
- ``host_view``: tensors to numpy for the wire (bf16 as ``uint16`` bits)
  and back bitwise (``from_host``);
- ``metrics``: the card's memory gauges (``gpu_gauges``), read only when
  the process has already brought CUDA up;
- ``profile``: a ``torch.profiler`` capture around a call or for a
  duration, exported as a Chrome trace;
- ``warm_template`` and ``shm_ring``: a replica's cold start, a template
  process that stages the weights in one shared segment once and forks
  replicas that boot through the compile cache (``serve/aot_cache.py``);
- ``elastic``: the drain half of the elastic contract (SIGTERM flips a
  flag a training loop polls, to flush and yield inside its grace).

Nothing here is imported by the fabric itself (its pod server is the JAX
package's); user code in a rank calls these.
"""

from .distributed_env import distributed
from .host_view import from_host, host_view
from .metrics import device_gauges, gpu_gauges
from .profile import capture

__all__ = ["distributed", "host_view", "from_host", "gpu_gauges",
           "device_gauges", "capture"]
