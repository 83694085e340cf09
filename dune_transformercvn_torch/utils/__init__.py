"""Utilities of the port: building the CUDA kernels (:mod:`.build`), the
compiled steps and their on-disk caches (:mod:`.compile`, :mod:`.cache`),
run directories (:mod:`.rundir`) and the parameter summary
(:mod:`.summary`)."""
