"""Counters and span times of the port's runs."""
