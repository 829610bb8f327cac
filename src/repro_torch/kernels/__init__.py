# Custom-kernel layer. bitonic_sort/ is the hand-written CUDA bitonic network
# behind local_impl="kernel" (core/seqsort.py) and impl="kernel"
# (engine/kv.py).
