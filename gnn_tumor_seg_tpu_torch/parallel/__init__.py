"""Distributed GNN training (counterpart of gnn_tumor_seg_tpu/parallel/):
one process per rank over a torch.distributed process group.

  mesh         the rank's mesh: world size, rank, device, backend, group
  collectives  the collectives the JAX package leaves to XLA, as autograd
               Functions (all_gather_rows, ring_exchange, all_reduce_sum)
  multihost    per-rank sample shards, rank-0 checkpoints, combined metrics
  dp           data-parallel minibatch training (ParallelGNNTrainer)
  halo         node-partitioned giant-graph models (p2p and all_gather)
  halo_data    dataset -> partitioned union graphs
  halo_trainer the trainer of the halo regime
"""
