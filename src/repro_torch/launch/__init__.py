"""Launchers of the port: the LM trainer (`train`) and the batched LM
server (`serve`).  The TPU dry-run waits for ROADMAP.md queue 1 item 11."""
