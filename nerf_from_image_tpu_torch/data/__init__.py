"""Datasets on disk: parsers, split loaders, image IO, the RLE codec."""
