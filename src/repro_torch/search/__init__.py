"""Streaming joint-space search: lazy lattices, chunked columnar pricing,
constant-memory Pareto frontiers and a population-based optimizer.

Entry points:

  * ``DesignSpace.product_iter`` -> ``LazySpace`` (lazy row-major product)
  * ``Evaluator.evaluate_stream`` / ``evaluate_stream`` (chunked pricing)
  * ``stream_frontier`` (lattice -> ``ParetoArchive`` in one pass)
  * ``evolve`` (NSGA-II-selected multi-start hillclimb fleet)
  * ``repro_torch.launch.search`` (CLI: ``--lattice`` / ``--evolve``)

A copy of ``repro.search`` (numpy only), held byte for byte to it by
``tests/test_torch_search.py``. See DESIGN.md §9.
"""
from repro_torch.search.evolve import EvolveResult, evolve, objective_matrix
from repro_torch.search.lazy import LazySpace
from repro_torch.search.moves import (DSE_AXES, arch_move, greedy,
                                      neighbors, placement_moves)
from repro_torch.search.pareto import (ParetoArchive, dominated_by,
                                       pareto_mask)
from repro_torch.search.stream import (DEFAULT_CHUNK, OBJECTIVES,
                                       LatticePricer, StreamChunk,
                                       chunk_objectives, evaluate_stream,
                                       stream_frontier)

__all__ = [
    "DEFAULT_CHUNK", "DSE_AXES", "OBJECTIVES", "EvolveResult", "LazySpace",
    "LatticePricer", "ParetoArchive", "StreamChunk", "arch_move",
    "chunk_objectives", "dominated_by", "evaluate_stream", "evolve",
    "greedy", "neighbors", "objective_matrix", "pareto_mask",
    "placement_moves", "stream_frontier",
]
