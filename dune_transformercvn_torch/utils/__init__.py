"""Utilities of the port: building the CUDA kernels (:mod:`.build`), run
directories (:mod:`.rundir`) and the parameter summary (:mod:`.summary`)."""
