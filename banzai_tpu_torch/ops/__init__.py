"""Device stages of the per-block pipeline, batched over blocks."""
