"""Model walks (PointMLP inference) over plain tensor dicts."""
