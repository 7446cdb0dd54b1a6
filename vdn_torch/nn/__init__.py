"""Modules: layers, DINOv2 ViT, DPT heads, motion modules."""
