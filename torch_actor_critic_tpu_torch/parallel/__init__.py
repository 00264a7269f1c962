"""Parallel training of the port: the host-loop population
(:mod:`.population`). The mesh (data-parallel, FSDP, sequence-parallel)
is not ported."""
