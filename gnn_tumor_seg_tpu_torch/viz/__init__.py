"""Plotting of predictions over the MRI (counterpart of
gnn_tumor_seg_tpu/viz/): host numpy, with matplotlib imported only where a
figure is drawn."""
