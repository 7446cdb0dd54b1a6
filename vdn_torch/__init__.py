"""vdn_torch: the PyTorch / CUDA (H100) port of vdn.

Imports torch and numpy only (never jax, flax, optax or orbax; cv2 and
matplotlib only inside the functions that read or write image and video
files).  Entry points, each on the card unless the caller passes
``device="cpu"``:

- clips: ``vdn_torch.models.video_depth_anything.
  build_video_depth_anything`` with ``vdn_torch.pipelines.infer_video.
  infer_video_depth``;
- streaming: the same model with ``vdn_torch.pipelines.stream.
  VideoDepthStreamPipeline``;
- single images with the cross-frame memory bank: ``vdn_torch.models.
  depth_anything_v2.build_depth_anything_v2`` with ``vdn_torch.pipelines.
  infer_image.DepthAnythingV2Pipeline``;
- metric depth: ``vdn_torch.models.metric_depth.
  build_metric_depth_anything_v2``;
- training: ``vdn_torch.models.refine.build_refine_video_depth`` with
  ``vdn_torch.train.trainer.RefineTrainer``, and the metric-depth model
  with ``vdn_torch.train.metric_depth.MetricDepthTrainer``;
- context-parallel clips over the frame axis: the same video model built
  with ``seq_axis="seq"``, ``vdn_torch.parallel.launch.
  initialize_distributed``, ``vdn_torch.parallel.mesh.make_mesh`` and
  ``vdn_torch.parallel.context.make_context_parallel_forward`` (a world
  of one on the card by default; torchrun's environment for more);
- the command-line tools ``python -m vdn_torch.cli.<name>`` (``run``,
  ``run_video``, ``run_metric``, ``pointcloud``, ``app``, ``eval_da2k``,
  ``eval_depthcrafter``; ``--device cpu`` for the CPU), loading weights
  through ``vdn_torch.core.checkpoint.load_checkpoint``.

The hand-written CUDA kernels and their build live in
``vdn_torch.kernels``.
"""
