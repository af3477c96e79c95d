"""File entry points: MatrixMarket input (``matrix_market``) and solver
checkpoints that either package resumes (``checkpoint``)."""
