"""Host-side data: CSR, blocked-ELL layouts, the libsvm readers, synthetic
data, partitions, the checksummed on-disk shard store, and the streamed
data plane that moves a store's chunks onto the device."""
from repro_torch.data.libsvm import load_libsvm, save_libsvm
from repro_torch.data.partition import (Partition, chunk_partition,
                                        equal_width_partition, imbalance,
                                        lpt_partition, make_partition)
from repro_torch.data.sparse import (BlockedEll, CSRMatrix, EllPair,
                                     EllPlan, build_shard_ell_pairs,
                                     ell_fill, ell_from_csr, ell_plan,
                                     ell_tile_widths, hvp_tile_dtype,
                                     iter_libsvm_chunks, load_libsvm_sparse,
                                     make_sparse_glm_data, pad_csr_rows,
                                     shard_csrs_from_partition,
                                     stack_shard_ells, truncate_features)
from repro_torch.data.store import ChunkInfo, ShardStore
from repro_torch.data.stream import (ChunkPrefetcher, PrefetchStats,
                                     StreamPlan, plan_streams,
                                     replan_streams)
from repro_torch.data.synthetic import REGIMES, make_glm_data, make_regime

__all__ = ["Partition", "chunk_partition", "equal_width_partition",
           "imbalance", "lpt_partition", "make_partition", "BlockedEll",
           "CSRMatrix", "EllPair", "EllPlan", "build_shard_ell_pairs",
           "ell_fill", "ell_from_csr", "ell_plan",
           "ell_tile_widths", "hvp_tile_dtype", "iter_libsvm_chunks",
           "load_libsvm", "load_libsvm_sparse", "make_sparse_glm_data",
           "pad_csr_rows", "save_libsvm", "shard_csrs_from_partition",
           "stack_shard_ells", "truncate_features", "ChunkInfo",
           "ShardStore", "ChunkPrefetcher", "PrefetchStats", "StreamPlan",
           "plan_streams", "replan_streams", "REGIMES", "make_glm_data",
           "make_regime"]
