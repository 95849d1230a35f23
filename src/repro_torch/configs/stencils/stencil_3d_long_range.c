double U[M][N][N];
double V[M][N][N];
double ROC[M][N][N];
double c0, c1, c2, c3, c4;
double lap;

for (int k = 4; k < M - 4; k++) {
  for (int j = 4; j < N - 4; j++) {
    for (int i = 4; i < N - 4; i++) {
      lap = c0 * V[k][j][i]
          + c1 * (V[k][j][i+1] + V[k][j][i-1])
          + c1 * (V[k][j+1][i] + V[k][j-1][i])
          + c1 * (V[k+1][j][i] + V[k-1][j][i])
          + c2 * (V[k][j][i+2] + V[k][j][i-2])
          + c2 * (V[k][j+2][i] + V[k][j-2][i])
          + c2 * (V[k+2][j][i] + V[k-2][j][i])
          + c3 * (V[k][j][i+3] + V[k][j][i-3])
          + c3 * (V[k][j+3][i] + V[k][j-3][i])
          + c3 * (V[k+3][j][i] + V[k-3][j][i])
          + c4 * (V[k][j][i+4] + V[k][j][i-4])
          + c4 * (V[k][j+4][i] + V[k][j-4][i])
          + c4 * (V[k+4][j][i] + V[k-4][j][i]);
      U[k][j][i] = 2. * V[k][j][i] - U[k][j][i] + ROC[k][j][i] * lap;
    }
  }
}
