"""Host pipelines: preprocessing and windowed clip inference."""
