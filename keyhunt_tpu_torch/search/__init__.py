"""Search engines built on the ops layer: BSGS (`bsgs`), the brute-force
walker (`walker`, `engine`, `vanity`) and minikeys (`minikeys`)."""
