"""Search engines built on the ops layer (BSGS)."""
