"""The benchmark's own machinery: finding cells, configurations, traffic
mixes, drivers and metric readers by name (:mod:`.spec`), the weights made
from the seed (:mod:`.weights`), the adapter to the port under test
(:mod:`.program`), the profiler's sub-window (:mod:`.trace`), statistics
(:mod:`.stats`) and the comparisons that decide ``correct``
(:mod:`.check`).

Nothing here imports the port at module level: :mod:`.program` does so
inside its functions, so the CPU tests can import every module."""
