"""Model-zoo presets (vdn/models/presets.py; reference run_video.py:28-33)."""

MODEL_CONFIGS = {
    "vits": dict(encoder="vits", features=64,
                 out_channels=(48, 96, 192, 384)),
    "vitb": dict(encoder="vitb", features=128,
                 out_channels=(96, 192, 384, 768)),
    "vitl": dict(encoder="vitl", features=256,
                 out_channels=(256, 512, 1024, 1024)),
}
