"""Join primitives: histogram, sorts and the merge-count probe."""
