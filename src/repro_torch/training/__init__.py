"""Training (PyTorch port of ``repro/training``): AdamW with EntroLLM-
quantized moments and the train loop."""
