double a[M][N][N];
double b[M][N][N];
double wC, wW, wE, wN, wS, wF, wB;

for (int k = 1; k < M - 1; k++) {
  for (int j = 1; j < N - 1; j++) {
    for (int i = 1; i < N - 1; i++) {
      b[k][j][i] = wC * a[k][j][i]
                 + wW * a[k][j][i-1] + wE * a[k][j][i+1]
                 + wS * a[k][j-1][i] + wN * a[k][j+1][i]
                 + wB * a[k-1][j][i] + wF * a[k+1][j][i];
    }
  }
}
