"""The paper's offline precomputation of the first layer."""
