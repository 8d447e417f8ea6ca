"""The join engine."""
