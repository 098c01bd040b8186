"""Distributed helpers of the port: the int8 quantizers of
:mod:`.compression` (the paged pool's int8 pages use them) and the fault
tolerance state machines of :mod:`.fault_tolerance` (heartbeats, the
re-mesh plan, the straggler watchdog) that the trainer drives.
Collectives, ring attention and meshes are ROADMAP queue 1, item 10."""
