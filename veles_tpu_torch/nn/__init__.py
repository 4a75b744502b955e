"""Layer functions of the port: activations, convolution, pooling, LRN
and learning-rate policies, as the fused classifier trainer uses them."""
