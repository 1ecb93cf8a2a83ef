"""Point-cloud numerics: quantization, BN fusion, URS sampling, kNN grouping."""
