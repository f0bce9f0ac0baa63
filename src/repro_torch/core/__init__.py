"""Geometry, operator spec, projector module and analytic reconstruction."""
