'''The extraction pipeline: queue-linked steps on threads and their runtime.

Exports the names of the JAX package's ``pipeline/__init__.py`` (``__all__``).
'''
from .pipeline import Pipeline, WorkerError, WorkerErrorInfo
from .pipeline_step import PipelineStep
from .steps import (FetchResultsStep, InferenceStep, PreviewEncodeStep, PreviewVideoWriterStep,
                    ProcessFeaturesStep, ProduceFramesStep, ResultWriterStep,
                    SelectInstancesStep)

__all__ = ['Pipeline', 'WorkerError', 'WorkerErrorInfo', 'PipelineStep', 'ProduceFramesStep',
           'InferenceStep', 'SelectInstancesStep', 'ProcessFeaturesStep', 'FetchResultsStep',
           'PreviewVideoWriterStep', 'PreviewEncodeStep', 'ResultWriterStep']
