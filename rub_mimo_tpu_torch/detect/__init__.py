"""MIMO detection (port of rub_mimo_tpu.detect): ZF, MMSE, SIC and ML
detectors, the SISO, diversity and Alamouti combiners, channel tracking,
and the equalizer dispatch and postprocessing the decode shares."""
