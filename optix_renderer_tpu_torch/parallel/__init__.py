"""Training on the scan path (`shard.py`); multi-device rendering is ROADMAP Queue 1 item 12."""
