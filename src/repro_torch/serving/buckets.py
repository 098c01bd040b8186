"""The length-bucket ladders (a copy of the JAX package's single definition).

Run-time tuning regions are keyed by sequence-length bucket, so every
layer that routes by length must read one ladder.  The port keeps the
same values, so its tuning records name the same buckets as the JAX
package's (:mod:`repro_torch.tuning.dynamic`).

* :data:`LENGTH_BUCKETS` — the production ladder (kv lengths up to 32k);
  the default of :func:`repro_torch.serving.engine.length_bucket`.
* :data:`REDUCED_BUCKETS` — the ladder of the reduced configs (never
  beyond 2k).
"""
from __future__ import annotations

LENGTH_BUCKETS: tuple[int, ...] = (128, 512, 2048, 8192, 32768)
REDUCED_BUCKETS: tuple[int, ...] = (128, 512, 2048)
