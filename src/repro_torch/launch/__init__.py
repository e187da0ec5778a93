"""Launchers of the port: the batched LM serving driver (`serve`).  The
trainer and the TPU dry-run wait for ROADMAP.md queue 1 item 11."""
