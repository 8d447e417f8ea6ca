"""Integer helpers of the generators and the grid's coordination files."""
