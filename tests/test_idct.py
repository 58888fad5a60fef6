"""IDCT and geometry unit tests, ported from the reference's inline tests."""

import numpy as np
import pytest

from jpeg_decoder_jax.ops.idct import (
    blocks_to_plane,
    choose_idct_size,
    dequantize_and_idct_blocks,
)
from jpeg_decoder_jax.parser import Component, Dimensions, update_component_sizes


def test_dequantize_and_idct_block_8x8():
    """`/root/reference/src/idct.rs:580-627` (tolerance +-1)."""
    coefficients = np.array([
        -14, -39, 58, -2, 3, 3, 0, 1,
        11, 27, 4, -3, 3, 0, 1, 0,
        -6, -13, -9, -1, -2, -1, 0, 0,
        -4, 0, -1, -2, 0, 0, 0, 0,
        3, 0, 0, 0, 0, 0, 0, 0,
        -3, -2, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0], dtype=np.int16)
    quantization_table = np.array([
        8, 6, 5, 8, 12, 20, 26, 31,
        6, 6, 7, 10, 13, 29, 30, 28,
        7, 7, 8, 12, 20, 29, 35, 28,
        7, 9, 11, 15, 26, 44, 40, 31,
        9, 11, 19, 28, 34, 55, 52, 39,
        12, 18, 28, 32, 41, 52, 57, 46,
        25, 32, 39, 44, 52, 61, 60, 51,
        36, 46, 48, 49, 56, 50, 52, 50], dtype=np.uint16)
    expected = np.array([
        118, 92, 110, 83, 77, 93, 144, 198,
        172, 116, 114, 87, 78, 93, 146, 191,
        194, 107, 91, 76, 71, 93, 160, 198,
        196, 100, 80, 74, 67, 92, 174, 209,
        182, 104, 88, 81, 68, 89, 178, 206,
        105, 64, 59, 59, 63, 94, 183, 201,
        35, 27, 28, 37, 72, 121, 203, 204,
        37, 45, 41, 47, 98, 154, 223, 208]).reshape(8, 8)

    out = dequantize_and_idct_blocks(coefficients[None, :], quantization_table, 8)[0]
    assert np.abs(out.astype(np.int16) - expected).max() <= 1


def test_dequantize_and_idct_block_8x8_all_zero():
    """`/root/reference/src/idct.rs:629-634`."""
    out = dequantize_and_idct_blocks(
        np.zeros((1, 64), np.int16), np.full(64, 666, np.uint16), 8)[0]
    assert (out == 128).all()


def test_dequantize_and_idct_block_8x8_saturated():
    """Wrapping-arithmetic hardening, exact output
    (`/root/reference/src/idct.rs:636-657`)."""
    expected = np.array([
        0, 0, 0, 255, 255, 0, 0, 255,
        0, 0, 215, 0, 0, 255, 255, 0,
        255, 255, 255, 255, 255, 0, 0, 255,
        0, 0, 255, 0, 255, 0, 255, 255,
        0, 0, 255, 255, 0, 255, 0, 0,
        255, 255, 0, 255, 255, 255, 170, 0,
        0, 255, 0, 0, 0, 0, 0, 255,
        255, 255, 0, 255, 0, 255, 0, 0]).reshape(8, 8)
    out = dequantize_and_idct_blocks(
        np.full((1, 64), 32767, np.int16), np.full(64, 65535, np.uint16), 8)[0]
    assert (out == expected).all()


@pytest.mark.parametrize("full,req,expected", [
    ((5472, 3648), (200, 200), 1),
    ((5472, 3648), (500, 500), 1),
    ((5472, 3648), (684, 456), 1),
    ((5472, 3648), (999, 456), 1),
    ((5472, 3648), (684, 999), 1),
    ((500, 333), (63, 42), 1),
    ((5472, 3648), (685, 999), 2),
    ((5472, 3648), (1000, 1000), 2),
    ((5472, 3648), (1400, 1400), 4),
    ((5472, 3648), (5472, 3648), 8),
    ((5472, 3648), (16384, 16384), 8),
    ((1, 1), (65535, 65535), 8),
])
def test_choose_idct_size(full, req, expected):
    """`/root/reference/src/idct.rs:30-203`."""
    assert choose_idct_size(Dimensions(*full), Dimensions(*req)) == expected


def test_update_component_sizes():
    """`/root/reference/src/parser.rs:312-329`."""
    components = [Component(
        identifier=1, horizontal_sampling_factor=2, vertical_sampling_factor=2,
        quantization_table_index=0)]
    mcu = update_component_sizes(Dimensions(800, 280), components)
    assert mcu == Dimensions(50, 18)
    assert components[0].block_size == Dimensions(100, 36)
    assert components[0].size == Dimensions(800, 280)


def test_blocks_to_plane():
    blocks = np.arange(2 * 64, dtype=np.uint8).reshape(2, 8, 8)
    plane = blocks_to_plane(blocks, blocks_wide=2, blocks_high=1)
    assert plane.shape == (8, 16)
    assert (plane[:, :8] == blocks[0]).all()
    assert (plane[:, 8:] == blocks[1]).all()


def test_scaled_idct_shapes():
    coeff = np.zeros((3, 64), np.int16)
    qt = np.ones(64, np.uint16)
    for scale in (8, 4, 2, 1):
        out = dequantize_and_idct_blocks(coeff, qt, scale)
        assert out.shape == (3, scale, scale)
        assert (out == 128).all()
