"""The benchmark of the rag_challenge_2_tpu_torch port: see README.md."""
