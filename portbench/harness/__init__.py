"""The harness: finds a cell's files by name (``spec``), makes its corpus
and division (``corpus``), counts a step's least work (``counts``), reads
the trace (``trace``) and runs a cell's drive and prints the result
(``cli``)."""
