"""PyTorch/CUDA port of legommenders_tpu (see ROADMAP.md)."""
