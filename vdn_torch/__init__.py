"""vdn_torch: the PyTorch / CUDA (H100) port of vdn.

Imports torch and numpy only (never jax, flax or cv2).  Entry points:
``vdn_torch.models.video_depth_anything.build_video_depth_anything`` (on
the card unless ``device="cpu"``), ``vdn_torch.pipelines.infer_video.
infer_video_depth`` (clips) and ``vdn_torch.pipelines.stream.
VideoDepthStreamPipeline`` (streaming).  The hand-written CUDA kernels and
their build live in ``vdn_torch.kernels``.
"""
