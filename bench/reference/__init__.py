"""The plain reference the benchmark holds the port to: a llama-layout
decoder in plain PyTorch, float32 with TF32 off (:mod:`.llama`), its
training step with the same AdamW (:mod:`.train`), and the lower-precision
control (fp8 products) that has to come out as not correct.  It imports
nothing of the port."""
