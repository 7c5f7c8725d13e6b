"""The system under test, ``deepinv_tpu_torch``, driven through its public
entry points only: each module here builds one piece from the benchmark's
own tensors and weights."""
