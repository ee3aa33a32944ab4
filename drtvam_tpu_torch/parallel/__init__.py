"""Multi-GPU execution on torch.distributed (counterpart of
drtvam_tpu/parallel/): one process a GPU, the wavefront's active pixels
or the ballistic engine's angles split over the ranks in contiguous
blocks, doses and pattern gradients summed by all_reduce."""
