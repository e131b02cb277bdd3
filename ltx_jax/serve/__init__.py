"""Serving subsystem: dynamic micro-batching + job queue + HTTP front-end.

No reference analog (the Swift CLI is strictly one-shot) — this turns the
serving primitives (batched decode sharing every weight read,
prompt-lookup speculative drafts) into a deployable stack.

Design note — why REQUEST-level micro-batching, not slot-level continuous
batching: the batched Gemma decode runs as ONE compiled device program
(lax.while_loop over tokens) precisely so that token steps never cross the
host boundary. Joining a new request mid-flight would require stepping the
loop from the host, paying a dispatch + readback PER TOKEN. Coalescing
requests at batch boundaries keeps the device program whole; a new arrival
waits at most one batch. Whether that trade holds on a GPU is not measured
yet (PERF.md, open questions).
"""

from ltx_jax.serve.batcher import MicroBatcher  # noqa: F401
from ltx_jax.serve.jobs import JobQueue  # noqa: F401
from ltx_jax.serve.server import make_server  # noqa: F401
