"""Search engines built on the ops layer: BSGS (`bsgs`) and the brute-force
walker (`walker`, `engine`, `vanity`)."""
