"""Data helpers of the port: camera models and projections."""
