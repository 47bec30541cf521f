# DNN model definitions: edge IR graphs for the MATCHA compiler (edge.py)
# and the JAX LM architecture stack (layers/transformer/rwkv6/rglru/moe).
