"""Integer helpers shared by the generators."""
