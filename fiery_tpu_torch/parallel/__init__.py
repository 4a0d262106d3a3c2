"""Training across processes (counterpart of fiery_tpu/parallel/): mesh.py."""
