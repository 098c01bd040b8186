"""Distributed helpers of the port.  Only the int8 quantizers of
:mod:`.compression` are ported so far (the paged pool's int8 pages use
them); collectives, ring attention and meshes are ROADMAP queue 1,
item 10."""
