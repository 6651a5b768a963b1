"""The benchmark's plain reference: data from the seed (``data``), brute-force
neighbours (``knn``), the graph rules the check needs (``graph``) and the
comparison and its precision control (``check``). Plain torch only: nothing
of the program, of its JAX original or of JAX."""
