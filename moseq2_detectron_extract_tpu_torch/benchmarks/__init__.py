'''Experiments of the port, runnable as modules
(``python -m moseq2_detectron_extract_tpu_torch.benchmarks.<name>``).'''
