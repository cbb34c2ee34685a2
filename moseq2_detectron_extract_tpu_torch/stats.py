'''Outlier statistics: the modified z-score test and the extremes without
outliers.

Port of ``moseq2_detectron_extract_tpu/stats.py`` (lines 5-35), numpy as
there.
'''
import numpy as np


def is_outlier(points: np.ndarray, thresh: float = 3.5) -> np.ndarray:
    '''MAD-based modified z-score outlier test (Iglewicz & Hoaglin): True
    where a point is an outlier. NaN-tolerant (nanmedian, nansum).'''
    points = np.asarray(points)
    if points.ndim == 1:
        points = points[:, None]
    median = np.nanmedian(points, axis=0)
    diff = np.sqrt(np.nansum((points - median) ** 2, axis=-1))
    mad = np.nanmedian(diff)
    with np.errstate(divide='ignore', invalid='ignore'):
        modified_z_score = 0.6745 * diff / mad
    return modified_z_score > thresh


def exclude_outliers(data: np.ndarray, threshold: float = 3.5) -> np.ndarray:
    '''The values of ``data`` that are not outliers.'''
    data = np.asarray(data)
    return data[~is_outlier(data, threshold)]


def max_exclude_outliers(data: np.ndarray, threshold: float = 3.5):
    '''The largest value of ``data`` that is not an outlier.'''
    return exclude_outliers(data, threshold).max()


def min_exclude_outliers(data: np.ndarray, threshold: float = 3.5):
    '''The smallest value of ``data`` that is not an outlier.'''
    return exclude_outliers(data, threshold).min()
