"""Tensor functions of the port: preprocessing, coordinates, decoding, PnP."""
