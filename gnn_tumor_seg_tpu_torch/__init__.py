"""PyTorch/CUDA port of gnn_tumor_seg_tpu for NVIDIA Hopper (sm_90a).

The JAX package beside it is the reference; this package mirrors its module
names and imports nothing of it, nor JAX. Entry points run on the GPU unless
the caller passes device="cpu"; on the CPU every kernel wrapper takes its plain
PyTorch version. Slice 1 covers the single-MRI serve path
(cli/predict_single.py): host preprocessing, GSpool forward with the
max-aggregation kernel (ops/kernels/max_agg.py), and the refinement CNN.
Slice 2 covers GNN training on one device (cli/train_gnn.py,
train/gnn_trainer.py) for GSpool, GSmean and GSgcn, with the backward
kernel of max aggregation and the sum/mean kernel (ops/kernels/sum_agg.py).
Slice 3 adds GAT to both (models/gat.py), with the fused attention kernels
and their backward (ops/kernels/fused_gat.py).
"""

__version__ = "0.1.0"
